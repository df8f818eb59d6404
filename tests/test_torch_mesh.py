"""The port's ('data', 'frame') mesh on torch.distributed, on the CPU
with gloo (tests/test_parallel.py, tests/test_multiprocess.py and
__graft_entry__.dryrun_multichip's contracts).

One spawn of 4 ranks (mesh 2 x 2, a file:// store under tmp_path) runs
every sharded check and writes its results; the test process computes
the unsharded port and JAX references meanwhile.

Tolerances: the sharded step, analyze_long and the corpus runner equal
the unsharded port bit for bit (stricter than test_parallel.py's
rtol=1e-12: a frame shard draws the whole utterance's fast-mode dither
and slices it).  Against the JAX package's unsharded float64 step on
the same inputs, the sharded float64 step meets the gates of
tests/test_torch_pipeline.py: F0 within 0.1 cent RMS with VUV > 0.99,
sp median < 0.01 dB, resynthesis envelope median < 0.5 dB.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from world_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
from world_tpu_torch.io.audio import wavwrite  # noqa: E402
from world_tpu_torch.io.parameterio import read_npz  # noqa: E402
from world_tpu_torch.parallel import analyze_long, pipeline  # noqa: E402
from world_tpu_torch.utils.corpus import BatchedCorpusRunner  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FS = 22050
X_LENGTH = 4200          # F = 39 frames: odd, so the frame pad is used
N_DATA, N_FRAME = 2, 2
# (F0 method, rng_mode, dtype) of the sharded steps with synthesis.
STEPS = [(m, r, d) for m in ("dio", "harvest")
         for r, d in (("none", "float32"), ("fast", "float32"),
                      ("none", "float64"))]
LONG = dict(fs=16000, chunk_seconds=0.25, halo_seconds=0.1,
            f0_method="dio", batch_lanes=3)
CORPUS = dict(fs=16000, bucket_sizes=[6000, 10000], batch_size=2,
              f0_method="dio", output_format="npz", codec_dims=16)


def _voiced(n, fs, batch, seed=0):
    """A voiced vowel-like batch: harmonic stacks with vibrato and an
    edge taper (the recipe of __graft_entry__._voiced)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    x = np.zeros((batch, n), np.float64)
    for b in range(batch):
        f0 = 150.0 * (1.0 + 0.1 * b) * (1.0 + 0.04 * np.sin(
            2 * np.pi * 3 * t))
        phase = 2 * np.pi * np.cumsum(f0) / fs
        for k in range(1, 6):
            x[b] += (0.5 / k) * np.sin(k * phase + 0.3 * k)
        x[b] *= 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
        x[b] += rng.randn(n) * 0.003
    return x


def _inputs(gold):
    x = gold["x"][:X_LENGTH]
    return {"dio": np.stack([x * g for g in (1.0, 0.7, 0.5, 0.3)]
                            ).astype(np.float32),
            "harvest": _voiced(X_LENGTH, FS, 4).astype(np.float32)}


def _long_signal():
    fs = LONG["fs"]
    t = np.arange(int(1.2 * fs)) / fs
    phase = np.cumsum(2 * np.pi * (130.0 + 25.0 * np.sin(
        2 * np.pi * 0.8 * t)) / fs)
    return (0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase)).astype(
        np.float32)


_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
root, store, work, rank = sys.argv[1], sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
sys.path.insert(0, root)
import torch.distributed as dist
with open(os.path.join(work, "config.json")) as f:
    globals().update(json.load(f))
from world_tpu_torch.parallel import analyze_long, pipeline
from world_tpu_torch.utils import distributed
from world_tpu_torch.utils.corpus import BatchedCorpusRunner

distributed.initialize("file://" + store, N_DATA * N_FRAME, rank,
                       device="cpu")
gathers = [0]
real_all_gather = dist.all_gather

def counting(*a, **k):
    gathers[0] += 1
    return real_all_gather(*a, **k)

dist.all_gather = counting
out, res = {}, {"rank": rank}
try:
    mesh = pipeline.make_mesh(N_DATA, N_FRAME, devices="cpu")
    inputs = np.load(os.path.join(work, "inputs.npz"))
    for method, rng, dtype in STEPS:
        case = f"{method}_{rng}_{dtype}"
        step = pipeline.make_batch_step(FS, X_LENGTH, rng_mode=rng,
                                        mesh=mesh, f0_method=method)
        gathers[0] = 0
        shard = step(inputs[method].astype(dtype))
        res[f"gathers_{case}"] = gathers[0]
        res[f"shapes_{case}"] = [list(t.shape) for t in shard]
        for name, t in zip(("f0", "sp", "ap", "y"),
                           pipeline.gather_outputs(shard, mesh)):
            out[f"{case}_{name}"] = t.numpy()
        local = float((shard[0] > 0).sum())
        res[f"voiced_{case}"] = distributed.allreduce_metrics(
            {"voiced_frames": local}, mesh=mesh)["voiced_frames"]
    step = pipeline.make_batch_step(FS, X_LENGTH, rng_mode="fast",
                                    mesh=mesh, with_synthesis=False)
    gathers[0] = 0
    shard = step(inputs["dio"])
    res["gathers_analysis"] = gathers[0]
    res["shapes_analysis"] = [list(t.shape) for t in shard[:3]]
    res["y_analysis"] = shard[3]
    try:
        pipeline.make_batch_step(FS, X_LENGTH, rng_mode="exact", mesh=mesh)
        res["exact_refused"] = False
    except ValueError:
        res["exact_refused"] = True
    long_kw = {k: v for k, v in LONG.items() if k != "fs"}
    for name, t in zip(("tp", "f0", "sp", "ap"), analyze_long(
            inputs["long"], LONG["fs"], mesh=mesh, **long_kw)):
        out[f"long_{name}"] = t
    runner = BatchedCorpusRunner(os.path.join(work, "corpus_mesh"),
                                 mesh=mesh, log=lambda *a: None, **CORPUS)
    written = []
    real_write = runner._write_utt

    def write(stem, *a, **k):
        written.append(os.path.basename(stem))
        return real_write(stem, *a, **k)

    runner._write_utt = write
    metrics = runner.run(sorted(
        os.path.join(work, "wavs", p)
        for p in os.listdir(os.path.join(work, "wavs"))))
    res["corpus_written"] = written
    res["corpus_done"] = metrics["utterances_done"]
finally:
    dist.all_gather = real_all_gather
    dist.destroy_process_group()
np.savez(os.path.join(work, "rank%d.npz" % rank), **out)
with open(os.path.join(work, "rank%d.json" % rank), "w") as f:
    json.dump(res, f)
"""


def _wavs(d):
    d.mkdir()
    rng = np.random.RandomState(3)
    fs = CORPUS["fs"]
    for i, n in enumerate((4000, 5200, 9000)):
        t = np.arange(n) / fs
        x = 0.3 * np.sin(2 * np.pi * (140.0 + 15 * i) * t) \
            + 0.01 * rng.randn(n)
        wavwrite(x, fs, str(d / f"w{i}.wav"))
    return sorted(str(p) for p in d.iterdir())


@pytest.fixture(scope="module")
def mesh_run(gold, tmp_path_factory):
    """The 4-rank spawn's results, with the unsharded port's and JAX's
    outputs on the same inputs (computed while the ranks run), and the
    output of the `scaling` command, run alongside."""
    work = tmp_path_factory.mktemp("mesh")
    inputs = dict(_inputs(gold), long=_long_signal())
    np.savez(work / "inputs.npz", **inputs)
    with open(work / "config.json", "w") as f:
        json.dump({"CORPUS": CORPUS, "FS": FS, "LONG": LONG,
                   "N_DATA": N_DATA, "N_FRAME": N_FRAME, "STEPS": STEPS,
                   "X_LENGTH": X_LENGTH}, f)
    paths = _wavs(work / "wavs")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, ROOT, str(work / "store"), str(work),
         str(r)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(N_DATA * N_FRAME)]
    scaling = subprocess.Popen(
        [sys.executable, "-m", "world_tpu_torch.tools", "scaling",
         "--devices", "1,2", "--batch-per-device", "1",
         "--seconds", "0.25", "--fs", "8000", "--iters", "1"],
        env=dict(env, WORLD_TPU_PLATFORM="cpu"), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs.append(scaling)
    try:
        ref = {}
        for method, rng, dtype in STEPS:
            step = pipeline.make_batch_step(FS, X_LENGTH, rng_mode=rng,
                                            f0_method=method, device="cpu")
            for name, t in zip(("f0", "sp", "ap", "y"),
                               step(inputs[method].astype(dtype))):
                ref[f"{method}_{rng}_{dtype}_{name}"] = t.numpy()
        long_kw = {k: v for k, v in LONG.items() if k != "fs"}
        for name, t in zip(("tp", "f0", "sp", "ap"), analyze_long(
                inputs["long"], LONG["fs"], device="cpu", **long_kw)):
            ref[f"long_{name}"] = t
        BatchedCorpusRunner(str(work / "corpus_ref"), device="cpu",
                            log=lambda *a: None, **CORPUS).run(paths)
        jax_ref = {}
        for method in ("dio", "harvest"):
            step = jax.jit(jax_pipeline.make_batch_step(
                FS, X_LENGTH, rng_mode="none", f0_method=method))
            jax_ref[method] = [np.asarray(a) for a in step(jnp.asarray(
                inputs[method].astype(np.float64)))]
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = []
    for r in range(N_DATA * N_FRAME):
        with np.load(work / f"rank{r}.npz") as z:
            arrays = dict(z)
        with open(work / f"rank{r}.json") as f:
            ranks.append((arrays, json.load(f)))
    return {"work": work, "ref": ref, "jax": jax_ref, "ranks": ranks,
            "scaling": outs[-1][0]}


@pytest.mark.parametrize("method,rng,dtype", STEPS)
def test_sharded_step_equals_unsharded(mesh_run, method, rng, dtype):
    """gather_outputs of the 2 x 2 step equals the unsharded step bit for
    bit in f0/sp/ap/y, on every rank."""
    for arrays, res in mesh_run["ranks"]:
        for name in ("f0", "sp", "ap", "y"):
            key = f"{method}_{rng}_{dtype}_{name}"
            np.testing.assert_array_equal(arrays[key], mesh_run["ref"][key],
                                          err_msg=f"rank {res['rank']} {key}")


def test_shard_shapes(mesh_run):
    """Each rank holds (B/n_data, F_r, K): F = 39 pads to 40, frame rank
    0 holds 20 frames, frame rank 1 19; y is the rank's rows."""
    f_r = {0: 20, 1: 19}
    for _, res in mesh_run["ranks"]:
        fr = f_r[res["rank"] % N_FRAME]
        for method, rng, dtype in STEPS:
            assert res[f"shapes_{method}_{rng}_{dtype}"] == [
                [2, fr], [2, fr, 513], [2, fr, 513], [2, 4190]]
        assert res["shapes_analysis"] == [[2, fr], [2, fr, 513],
                                          [2, fr, 513]]
        assert res["y_analysis"] is None


def test_one_gather_with_synthesis_none_without(mesh_run):
    """Synthesis gathers f0/sp/ap along 'frame' in one all_gather; the
    analysis step makes no collective call."""
    for _, res in mesh_run["ranks"]:
        for case in ("_".join(c) for c in STEPS):
            assert res[f"gathers_{case}"] == 1, (case, res)
        assert res["gathers_analysis"] == 0


def test_exact_rng_refused_on_frame_axis(mesh_run):
    assert all(res["exact_refused"] for _, res in mesh_run["ranks"])


def test_allreduce_metrics_on_mesh(mesh_run):
    """Each rank's voiced count of its own shard, summed over the mesh,
    is the global count (tests/test_multiprocess.py:50-56)."""
    for case in ("_".join(c) for c in STEPS):
        want = float((mesh_run["ref"][f"{case}_f0"] > 0).sum())
        assert want > 0
        for _, res in mesh_run["ranks"]:
            assert res[f"voiced_{case}"] == want


def test_analyze_long_on_mesh(mesh_run):
    """Chunk rows on 'data' (5 chunks in batches of 3, padded to the
    data axis): the result equals the unsharded call on every rank."""
    for arrays, _ in mesh_run["ranks"]:
        for name in ("tp", "f0", "sp", "ap"):
            np.testing.assert_array_equal(arrays[f"long_{name}"],
                                          mesh_run["ref"][f"long_{name}"])
    assert (mesh_run["ref"]["long_f0"] > 0).mean() > 0.5


def test_corpus_runner_on_mesh(mesh_run):
    """The sharded runner writes the unsharded runner's files and
    checkpoint; only rank 0 writes."""
    work = mesh_run["work"]
    got, want = work / "corpus_mesh", work / "corpus_ref"
    names = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in got.iterdir()) == names
    for name in names:
        if name.endswith(".npz"):
            a, b = read_npz(str(got / name)), read_npz(str(want / name))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)

    def marks(d):
        with open(d / "checkpoint.jsonl") as f:
            return sorted((r["utterance"], r["status"], r["frames"])
                          for r in map(json.loads, f))
    assert marks(got) == marks(want) and len(marks(got)) == 3
    for _, res in mesh_run["ranks"]:
        assert sorted(res["corpus_written"]) == (
            ["w0", "w1", "w2"] if res["rank"] == 0 else [])
        assert res["corpus_done"] == 3


@pytest.mark.parametrize("method", ["dio", "harvest"])
def test_sharded_step_meets_jax_gates(mesh_run, method):
    """The sharded float64 step's gathered outputs against the JAX
    package's unsharded float64 step on the same inputs, rng_mode
    "none"."""
    got = [mesh_run["ranks"][0][0][f"{method}_none_float64_{n}"]
           for n in ("f0", "sp", "ap", "y")]
    want = mesh_run["jax"][method]
    for row in range(4):
        f0, ref = got[0][row], want[0][row]
        assert ((f0 > 0) == (ref > 0)).mean() > 0.99
        v = (f0 > 0) & (ref > 0)
        assert v.sum() > 0
        cents = 1200 * np.abs(np.log2(f0[v] / ref[v]))
        assert np.sqrt((cents ** 2).mean()) < 0.1
        err_db = np.abs(10 * np.log10(got[1][row] / want[1][row]))
        assert np.median(err_db) < 0.01, np.median(err_db)
        ref_y = want[3][row]
        n = (len(ref_y) // 256) * 256
        re = ref_y[:n].reshape(-1, 256).std(axis=1)
        ye = got[3][row][:n].reshape(-1, 256).std(axis=1)
        act = re > re.max() * 0.03
        assert np.median(20 * np.abs(np.log10(ye[act] / re[act]))) < 0.5


def test_make_mesh_needs_a_group_and_a_matching_shape(tmp_path):
    """Without a process group make_mesh raises and names
    distributed.initialize; in a world of one, a (2, 1) mesh is refused
    and a (1, 1) mesh runs the unsharded step's computation."""
    import torch.distributed as dist

    from world_tpu_torch.utils import distributed

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="distributed.initialize"):
        pipeline.make_mesh(1, 1, devices="cpu")
    with pytest.raises(TypeError):
        pipeline.make_batch_step(FS, X_LENGTH, mesh=object(), device="cpu")
    distributed.initialize(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        with pytest.raises(ValueError):
            pipeline.make_mesh(2, 1, devices="cpu")
        with pytest.raises(ValueError):
            pipeline.make_mesh(1, 1, devices="tpu")
        mesh = pipeline.make_mesh(devices="cpu")
        assert pipeline.mesh_shape(mesh) == (1, 1)
        step = pipeline.get_batch_step(FS, X_LENGTH, rng_mode="fast",
                                       mesh=mesh)
        assert pipeline.get_batch_step(FS, X_LENGTH, rng_mode="fast",
                                       mesh=mesh) is step
        x = np.zeros((2, X_LENGTH), np.float32)
        x[:, 1000:3000] = 0.3 * np.sin(np.arange(2000) * 0.06)
        want = pipeline.make_batch_step(FS, X_LENGTH, rng_mode="fast",
                                        device="cpu")(x)
        for a, b in zip(pipeline.gather_outputs(step(x), mesh), want):
            assert torch.equal(a, b)
        with pytest.raises(ValueError):
            pipeline.make_batch_step(FS, X_LENGTH, mesh=mesh, device="cuda")
    finally:
        dist.destroy_process_group()


def test_scaling_cli_smoke(mesh_run):
    """`scaling --devices 1,2 --batch-per-device 1 --seconds 0.25 --fs
    8000 --iters 1` on the CPU (tests/test_parallel.py:84-107): one row
    per mesh size, valid JSON with the efficiency fields."""
    rec = json.loads(mesh_run["scaling"].strip().splitlines()[-1])
    assert rec["metric"] == "scaling_efficiency"
    assert rec["platform"] == "cpu" and rec["backend"] == ["gloo"]
    assert [r["devices"] for r in rec["rows"]] == [1, 2]
    assert all(r["throughput_xrt"] > 0 for r in rec["rows"])
    assert rec["rows"][0]["efficiency"] == 1.0
    assert "note" in rec
