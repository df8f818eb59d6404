"""The port's corpus runner and its helpers (world_tpu_torch.utils:
corpus, distributed, profiling) on the CPU: every case of
tests/test_corpus.py, the same corpus through world_tpu's
BatchedCorpusRunner and the port's, fast-mode output independent of the
batch size, at most two batches in flight, a two-process gloo
allreduce, and a profiled step's Chrome trace.

Tolerances: stored coded arrays equal the codec of a full step's outputs
within rtol/atol 2e-4 (tests/test_corpus.py's gate); against world_tpu's
runner (rng_mode "none", float32 Dio step) F0 meets
test_torch_dio.f32_jax_gate (the golden StoneMask track for the
fixture, the port's float64 Dio -> StoneMask for the other files) and
the decoded sp the median < 0.01 dB of tests/test_torch_pipeline.py,
the coded ap the same 0.01 dB as a median absolute difference; across
batch sizes in fast mode files are equal within rtol 1e-6 (float32).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_dio import f32_jax_gate  # noqa: E402
from world_tpu_torch import config  # noqa: E402
from world_tpu_torch.io.audio import wavread, wavwrite  # noqa: E402
from world_tpu_torch.io.parameterio import (load_npz_parameters,  # noqa: E402
                                            read_f0, read_npz)
from world_tpu_torch.utils import distributed, profiling  # noqa: E402
from world_tpu_torch.utils.corpus import (BatchedCorpusRunner,  # noqa: E402
                                          CorpusRunner)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
QUIET = dict(log=lambda *a: None, device="cpu")


def _make_wavs(tmp_path, n=3, fs=8000):
    paths = []
    rng = np.random.RandomState(0)
    for i in range(n):
        t = np.arange(4000) / fs
        x = 0.4 * np.sin(2 * np.pi * (120 + 10 * i) * t) \
            + 0.01 * rng.randn(4000)
        p = tmp_path / f"utt{i}.wav"
        wavwrite(x, fs, str(p))
        paths.append(str(p))
    return paths


def _tones(tmp_path, stem, lengths, seed, fs=16000):
    rng = np.random.RandomState(seed)
    paths = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / fs
        x = 0.3 * np.sin(2 * np.pi * 150.0 * t) + 0.01 * rng.randn(n)
        p = tmp_path / f"{stem}{i}.wav"
        wavwrite(x.astype(np.float64), fs, str(p))
        paths.append(str(p))
    return paths


def test_corpus_run_and_resume(tmp_path):
    paths = _make_wavs(tmp_path)
    out = tmp_path / "out"
    runner = CorpusRunner(str(out), f0_method="dio", rng_mode="none",
                          **QUIET)
    m = runner.run(paths)
    assert m["utterances_done"] == 3
    assert m["utterances_failed"] == 0
    for i in range(3):
        for ext in (".f0", ".sp", ".ap"):
            assert (out / f"utt{i}{ext}").exists()
    m2 = CorpusRunner(str(out), f0_method="dio", rng_mode="none",
                      **QUIET).run(paths)
    assert m2["utterances_done"] == 0
    assert m2["utterances_skipped"] == 3


def test_corpus_records_failures(tmp_path):
    paths = _make_wavs(tmp_path, n=1)
    bad = tmp_path / "broken.wav"
    bad.write_bytes(b"not a wav at all")
    out = tmp_path / "out"
    runner = CorpusRunner(str(out), f0_method="dio", rng_mode="none",
                          max_retries=1, **QUIET)
    m = runner.run([str(bad)] + paths)
    assert m["utterances_failed"] == 1
    assert m["utterances_done"] == 1
    recs = [json.loads(line) for line in open(out / "checkpoint.jsonl")]
    statuses = {r["utterance"]: r["status"] for r in recs}
    assert statuses["broken.wav"] == "failed"
    assert statuses["utt0.wav"] == "ok"


def test_allreduce_metrics():
    m = distributed.allreduce_metrics({"frames": 100, "note": "x"})
    assert m == {"frames": 100.0}
    # A mesh must come from make_mesh (tests/test_torch_mesh.py).
    with pytest.raises(TypeError):
        distributed.allreduce_metrics({"frames": 1}, mesh=object())


def test_shard_utterances():
    parts = [distributed.shard_utterances(list(range(10)), i, 3)
             for i in range(3)]
    assert sorted(sum(parts, [])) == list(range(10))
    assert all(len(p) >= 3 for p in parts)
    assert distributed.shard_utterances(range(4)) == [0, 1, 2, 3]
    distributed.initialize()                      # one process: a no-op


_WORKER = r"""
import json, sys
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from world_tpu_torch.utils import distributed
rank = int(sys.argv[3])
distributed.initialize(sys.argv[2], 2, rank, device="cpu")
m = distributed.allreduce_metrics(
    {"frames": 10 * (rank + 1), "audio_seconds": 0.25, "loader": "native"})
print(json.dumps({"metrics": m,
                  "shard": distributed.shard_utterances(range(5))}),
      flush=True)
dist.destroy_process_group()    # exiting inside the group can abort gloo
"""


def test_allreduce_metrics_two_processes():
    """Two processes on gloo: numeric metrics summed (float64), other
    values dropped; shard_utterances splits by rank."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, ROOT, f"localhost:{port}", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert time.perf_counter() - t0 < 20.0
    for r, o in enumerate(outs):
        assert o["metrics"] == {"audio_seconds": 0.5, "frames": 30.0}
        assert o["shard"] == list(range(5))[r::2]


def test_batched_corpus_runner(tmp_path):
    """Bucketed batched analysis writes the parameter files, reports the
    native loader, resumes from its checkpoint, and records failures
    without aborting."""
    paths = _tones(tmp_path, "u", (4000, 5200, 9000), 3)
    bad = tmp_path / "broken.wav"
    bad.write_bytes(b"not a wav")
    paths.append(str(bad))
    out = tmp_path / "out"
    kw = dict(bucket_sizes=[6000, 10000], batch_size=2, f0_method="dio",
              **QUIET)
    m = BatchedCorpusRunner(str(out), 16000, **kw).run(paths)
    assert m["utterances_done"] == 3
    assert m["utterances_failed"] == 1
    assert m["loader"] == "native"
    for i in range(3):
        _, f0 = read_f0(str(out / f"u{i}.f0"))
        assert (f0 > 0).mean() > 0.5
        n = (4000, 5200, 9000)[i]
        assert len(f0) == config.get_samples_for_dio(16000, n, 5.0)
    m2 = BatchedCorpusRunner(str(out), 16000, **kw).run(paths)
    assert m2["utterances_done"] == 0
    assert m2["utterances_skipped"] == 4   # the failure is checkpointed too


def _flaky_batched_runner(tmp_path, out_name, failures_per_step):
    """BatchedCorpusRunner whose step raises ``failures_per_step`` times
    before succeeding."""
    paths = _tones(tmp_path, "v", (4000, 5200), 5)
    runner = BatchedCorpusRunner(str(tmp_path / out_name), 16000,
                                 bucket_sizes=[6000], batch_size=2,
                                 f0_method="dio", max_retries=1, **QUIET)
    real_step_for = runner._step_for
    calls = {"n": 0}

    def flaky_step_for(fs_b, length):
        real = real_step_for(fs_b, length)

        def step(xb):
            calls["n"] += 1
            if calls["n"] <= failures_per_step:
                raise RuntimeError("transient device failure")
            return real(xb)

        return step

    runner._step_for = flaky_step_for
    return runner, paths, calls


def test_batched_corpus_step_retry(tmp_path):
    runner, paths, calls = _flaky_batched_runner(tmp_path, "out", 1)
    m = runner.run(paths)
    assert m["utterances_done"] == 2
    assert m["utterances_failed"] == 0
    assert calls["n"] == 2  # fail, retry-succeed


def test_batched_corpus_step_fallback(tmp_path):
    runner, paths, calls = _flaky_batched_runner(tmp_path, "out2", 99)
    m = runner.run(paths)
    assert m["utterances_done"] == 2
    assert m["utterances_failed"] == 0
    assert calls["n"] == 2  # max_retries=1 -> two attempts, then per-file
    for i in range(2):
        for ext in (".f0", ".sp", ".ap"):
            assert (tmp_path / "out2" / f"v{i}{ext}").exists()


def test_batched_corpus_npz_codec(tmp_path):
    """Coded sp/ap stored as float32 npz equal the codec of the full
    batched outputs; load_npz_parameters restores full-size
    parameters."""
    from world_tpu_torch.models.codec import (code_aperiodicity,
                                              code_spectral_envelope)
    from world_tpu_torch.parallel.pipeline import make_batch_step

    fs, dims = 16000, 32
    paths = _tones(tmp_path, "w", (4000, 5200), 7)
    out = tmp_path / "npz_out"
    kw = dict(bucket_sizes=[6000], batch_size=2, f0_method="dio",
              output_format="npz", codec_dims=dims, **QUIET)
    m = BatchedCorpusRunner(str(out), fs, **kw).run(paths)
    assert m["utterances_done"] == 2 and m["utterances_failed"] == 0

    rows = np.zeros((2, 6000), np.float32)
    for i, p in enumerate(paths):
        x, _, _ = wavread(p)
        rows[i, : len(x)] = x
    f0b, spb, apb, _ = make_batch_step(fs, 6000, f0_method="dio",
                                       with_synthesis=False,
                                       device="cpu")(rows)
    fft_size = config.get_fft_size_for_cheaptrick(fs)
    for i in range(2):
        d = read_npz(str(out / f"w{i}.npz"))
        nf = d["f0"].shape[0]
        assert d["coded_sp"].shape == (nf, dims)
        assert d["coded_sp"].dtype == np.float32
        want_sp = code_spectral_envelope(spb[i][:nf].double(), fs, dims,
                                         fft_size, device="cpu").numpy()
        np.testing.assert_allclose(d["coded_sp"], want_sp, rtol=2e-4,
                                   atol=2e-4)
        want_ap = code_aperiodicity(apb[i][:nf].double(), fs, fft_size,
                                    device="cpu").numpy()
        np.testing.assert_allclose(d["coded_ap"], want_ap, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(d["f0"], f0b[i][:nf].numpy(), rtol=1e-5)
        f0r, spr, apr, info = load_npz_parameters(str(out / f"w{i}.npz"),
                                                  device="cpu")
        assert spr.shape == (nf, fft_size // 2 + 1)
        assert apr.shape == (nf, fft_size // 2 + 1)
        assert info["fs"] == fs and info["fft_size"] == fft_size
        assert np.isfinite(spr).all() and (spr > 0).all()
        assert (apr > 0).all() and (apr <= 1.0).all()
    m2 = BatchedCorpusRunner(str(out), fs, **kw).run(paths)
    assert m2["utterances_skipped"] == 2 and m2["utterances_done"] == 0


def test_batched_corpus_npz_fallback_full_res(tmp_path):
    runner, paths, calls = _flaky_batched_runner(tmp_path, "npz_fb", 99)
    runner.output_format = "npz"
    runner.codec_dims = 16
    m = runner.run(paths)
    assert m["utterances_done"] == 2 and m["utterances_failed"] == 0
    for i in range(2):
        d = read_npz(str(tmp_path / "npz_fb" / f"v{i}.npz"))
        assert "spectrogram" in d and "coded_sp" not in d
        f0r, spr, apr, info = load_npz_parameters(
            str(tmp_path / "npz_fb" / f"v{i}.npz"), device="cpu")
        assert spr.shape[1] == info["fft_size"] // 2 + 1


def test_corpus_codec_requires_npz(tmp_path):
    with pytest.raises(ValueError):
        BatchedCorpusRunner(str(tmp_path / "x"), 16000, [4000],
                            codec_dims=32, output_format="ref",
                            device="cpu")


def test_batched_corpus_mixed_rates(tmp_path):
    """fs=None + bucket_seconds: each file at its own header rate, with
    per-(fs, length) steps and per-rate fft sizes, one checkpoint."""
    rng = np.random.RandomState(5)
    paths, rates = [], {}
    for i, (fs, n) in enumerate(((8000, 3000), (16000, 7000),
                                 (8000, 4600), (16000, 5500))):
        t = np.arange(n) / fs
        x = 0.3 * np.sin(2 * np.pi * 150.0 * t) + 0.01 * rng.randn(n)
        p = tmp_path / f"m{i}.wav"
        wavwrite(x.astype(np.float64), fs, str(p))
        paths.append(str(p))
        rates[f"m{i}"] = (fs, n)
    out = tmp_path / "out"
    kw = dict(fs=None, bucket_seconds=[0.6, 1.0], batch_size=2,
              f0_method="dio", output_format="npz", **QUIET)
    m = BatchedCorpusRunner(str(out), **kw).run(paths)
    assert m["utterances_done"] == 4, m
    assert m["utterances_failed"] == 0, m
    for stem, (fs, n) in rates.items():
        f0, sp, ap, info = load_npz_parameters(str(out / f"{stem}.npz"),
                                               device="cpu")
        assert info["fs"] == fs
        fft = info["fft_size"]
        assert fft == config.get_fft_size_for_cheaptrick(fs)
        nf = config.get_samples_for_dio(fs, n, 5.0)
        assert f0.shape[0] == nf
        assert sp.shape == (nf, fft // 2 + 1)
        assert (np.asarray(f0) > 0).mean() > 0.5
    m2 = BatchedCorpusRunner(str(out), **kw).run(paths)
    assert m2["utterances_skipped"] == 4


def test_batched_corpus_rejects_ambiguous_rate_config(tmp_path,
                                                      monkeypatch):
    with pytest.raises(ValueError):
        BatchedCorpusRunner(str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError):
        BatchedCorpusRunner(str(tmp_path / "b"), fs=None, device="cpu")
    with pytest.raises(TypeError):
        BatchedCorpusRunner(str(tmp_path / "c"), 16000, [4000],
                            mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedCorpusRunner(str(tmp_path / "d"), 16000, [4000])


@pytest.fixture(scope="module")
def fixture_corpus(tmp_path_factory):
    """The 22.05 kHz fixture and two variants as 16-bit wavs."""
    d = tmp_path_factory.mktemp("corpus22k")
    shutil.copy(os.path.join(HERE, "vaiueo2d.wav"), d / "f0.wav")
    x, fs, _ = wavread(os.path.join(HERE, "vaiueo2d.wav"))
    wavwrite(0.6 * x, fs, str(d / "f1.wav"))
    wavwrite(np.roll(x, 4000)[:14000], fs, str(d / "f2.wav"))
    return [str(d / f"f{i}.wav") for i in range(3)], fs


def test_batched_runner_matches_jax_runner(fixture_corpus, tmp_path, gold):
    """The same files through world_tpu's BatchedCorpusRunner and the
    port's (Dio, rng_mode "none", codec 32, npz)."""
    from world_tpu.utils.corpus import BatchedCorpusRunner as JaxRunner
    from world_tpu_torch import dio, stone_mask

    paths, fs = fixture_corpus
    kw = dict(bucket_sizes=[20000], batch_size=3, f0_method="dio",
              rng_mode="none", output_format="npz", codec_dims=32,
              log=lambda *a: None)
    JaxRunner(str(tmp_path / "jax"), fs, **kw).run(paths)
    BatchedCorpusRunner(str(tmp_path / "port"), fs, device="cpu",
                        **kw).run(paths)
    for i, p in enumerate(paths):
        got = read_npz(str(tmp_path / "port" / f"f{i}.npz"))
        want = read_npz(str(tmp_path / "jax" / f"f{i}.npz"))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        if i == 0:
            golden = gold["stonemask_f0"]
        else:
            x, _, _ = wavread(p)
            tp, f0 = dio(x, fs, device="cpu")
            golden = stone_mask(x, fs, tp, f0, device="cpu").numpy()
        f32_jax_gate(got["f0"].astype(np.float64),
                     want["f0"].astype(np.float64), golden)
        sp = [load_npz_parameters(str(tmp_path / w / f"f{i}.npz"),
                                  device="cpu")[1] for w in ("port", "jax")]
        err_db = np.abs(10 * np.log10(sp[0] / sp[1]))
        assert np.median(err_db) < 0.01, np.median(err_db)
        ap_db = np.abs(got["coded_ap"].astype(np.float64)
                       - want["coded_ap"].astype(np.float64))
        assert np.median(ap_db) < 0.01, np.median(ap_db)


def test_fast_mode_output_independent_of_batch_size(fixture_corpus,
                                                    tmp_path):
    """A file's parameters do not depend on which files share its batch,
    nor on the zero rows that pad the last batch."""
    paths, fs = fixture_corpus
    outs = {}
    for bs in (1, 2):
        out = tmp_path / f"bs{bs}"
        m = BatchedCorpusRunner(str(out), fs, bucket_sizes=[20000],
                                batch_size=bs, f0_method="dio",
                                output_format="npz", codec_dims=32,
                                **QUIET).run(paths)
        assert m["utterances_done"] == 3
        outs[bs] = [read_npz(str(out / f"f{i}.npz")) for i in range(3)]
    for a, b in zip(outs[1], outs[2]):
        for k in ("f0", "coded_sp", "coded_ap"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0)


def test_at_most_two_batches_in_flight(tmp_path):
    """Batch k is launched before batch k-1 is read, and never more than
    two batches are outstanding."""
    paths = _tones(tmp_path, "q", (3000, 3100, 3200, 3300, 3400), 9)
    runner = BatchedCorpusRunner(str(tmp_path / "out"), 16000,
                                 bucket_sizes=[4000], batch_size=1,
                                 f0_method="dio", **QUIET)
    events = []
    real = runner._dispatch

    class Read:
        def synchronize(self):
            events.append("read")

    def dispatch(step, rows):
        events.append("dispatch")
        return real(step, rows)[0], Read()

    runner._dispatch = dispatch
    m = runner.run(paths)
    assert m["utterances_done"] == 5
    assert events[:3] == ["dispatch", "dispatch", "read"]
    outstanding = np.cumsum([1 if e == "dispatch" else -1 for e in events])
    assert outstanding.max() == 2 and outstanding[-1] == 0


def test_stage_timer_and_trace(tmp_path):
    """StageTimer's JSON line; profiling.trace() profiles a step with the
    program's tracing on and exports a Chrome trace that holds its spans
    and stages; tracing is off again after it."""
    from world_tpu_torch import device
    from world_tpu_torch.parallel.pipeline import make_batch_step

    lines = []
    timer = profiling.StageTimer(2.0, log=lines.append, device="cpu")
    with timer.stage("fft", frames=400):
        torch.fft.rfft(torch.ones(4096))
    rec = json.loads(lines[0])
    assert rec["stage"] == "fft" and rec["ms"] >= 0
    assert timer.records["fft"] == rec and "frames_per_s" in rec
    x = 0.4 * np.sin(2 * np.pi * 150.0 * np.arange(4000) / 8000.0)
    step = make_batch_step(8000, 4000, f0_method="dio",
                           with_synthesis=False, device="cpu")
    with profiling.trace(str(tmp_path / "tr")) as prof:
        assert device.tracing()
        step(x[None].astype(np.float32))
    assert prof is not None and not device.tracing()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"span:step", "stage:dio", "stage:d4c",
            "span:sync.d4c.n_pass"} <= names
