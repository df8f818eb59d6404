"""Does a file's output depend on its batch?  The corpus of chip_smoke.py
through the batched Dio step on the card, each picked file in its batch,
in the batch rolled by one row, and alone.

    python world_tpu_torch/tools/batch_invariance.py [--root DIR]
        [--out FILE]

The corpus: ``corpus_signals`` (200 seeded signals, half at 22.05 kHz and
half at 48 kHz, the golden utterances tiled and cut to 1-8 s at gains
0.3-1.5), each quantized as a 16-bit wav stores it.  The files are
grouped as BatchedCorpusRunner(bucket_seconds=[2, 4, 8], batch_size=16)
groups them: by rate and by the first bucket that holds them, in order,
16 rows at a time, zero rows after the last.  In each (rate, bucket)
group above 2 s the middle file is picked, and its batch goes through
``get_batch_step(fs, bucket, rng_mode="fast", f0_method="dio",
with_synthesis=False, codec_dims=64)`` as formed, rolled by one row, and
with the file alone (a batch of 1).  Reported per file: the max abs
difference of f0 (Hz), coded sp and coded ap (dB) of the rolled and the
alone runs from the batch's, over the file's frames.  ``--root`` imports
world_tpu_torch from another checkout (for example the parent commit,
unpacked with ``git archive``), so both are read by the same comparison.
One JSON line per file and a last line of maxima; needs a CUDA device.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
BUCKETS = (2, 4, 8)
BATCH = 16
CODEC_DIMS = 64


def corpus_signals(n_files=200, seed=20261016):
    """[(fs, float64 signal)]: file i at 22.05 kHz for even i, 48 kHz for
    odd, the golden utterance tiled from a seeded start, cut to a seeded
    1-8 s and scaled by a seeded gain in 0.3-1.5."""
    rng = np.random.default_rng(seed)
    sources = {22050: np.fromfile(REPO / "tests" / "goldens" / "x.f64"),
               48000: np.fromfile(REPO / "tests" / "goldens_fs48" / "x.f64")}
    out = []
    for i in range(n_files):
        fs = (22050, 48000)[i % 2]
        x = sources[fs]
        n = int(rng.uniform(1.0, 8.0) * fs)
        start = int(rng.integers(len(x)))
        tiled = np.tile(x, n // len(x) + 2)[start: start + n]
        out.append((fs, tiled * rng.uniform(0.3, 1.5)))
    return out


def as_wav_samples(x):
    """x as a 16-bit wav stores it and the wav reader returns it."""
    pcm = np.clip((np.asarray(x, np.float64) * 32767).astype(np.int64),
                  -32768, 32767)
    return pcm / 32768.0


def picked_batches(lengths_fs):
    """For each (fs, bucket) group above the smallest bucket, in sorted
    order: (fs, bucket samples, picked file's index, its row, the indices
    of its batch)."""
    members = {}
    for idx, (n, fs) in enumerate(lengths_fs):
        b = next(int(np.ceil(s * fs)) for s in BUCKETS
                 if n <= int(np.ceil(s * fs)))
        members.setdefault((fs, b), []).append(idx)
    for (fs, b), ps in sorted(members.items()):
        if b == int(np.ceil(BUCKETS[0] * fs)):
            continue
        i = len(ps) // 2
        r = i % BATCH
        yield fs, b, ps[i], r, ps[i - r: i - r + BATCH]


def compare(pipeline, signals, device="cuda"):
    """Per picked file: the rolled and the alone runs against its batch,
    through ``pipeline`` (world_tpu_torch.parallel.pipeline)."""
    from world_tpu_torch import config

    results = []
    for fs, b, idx, r, batch in picked_batches(
            [(len(x), fs) for fs, x in signals]):
        rows = np.zeros((BATCH, b), np.float32)
        for j, k in enumerate(batch):
            x = as_wav_samples(signals[k][1])
            rows[j, :len(x)] = x
        step = pipeline.get_batch_step(fs, b, rng_mode="fast",
                                       f0_method="dio", with_synthesis=False,
                                       codec_dims=CODEC_DIMS,
                                       device=device)
        base = [t[r].cpu().numpy() for t in step(rows)[:3]]
        runs = {"rolled": [t[(r + 1) % BATCH].cpu().numpy()
                           for t in step(np.roll(rows, 1, axis=0))[:3]],
                "alone": [t[0].cpu().numpy()
                          for t in step(rows[r][None])[:3]]}
        nf = config.get_samples_for_dio(fs, len(signals[idx][1]), 5.0)
        d = {"file": idx, "fs": fs, "bucket": b, "row": r}
        for how, outs in runs.items():
            d[how] = {key: float(np.abs(a[:nf] - w[:nf]).max())
                      for key, a, w in zip(("f0", "coded_sp", "coded_ap"),
                                           outs, base)}
            d[how]["vuv_equal"] = bool(
                ((outs[0][:nf] > 0) == (base[0][:nf] > 0)).all())
        results.append(d)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import world_tpu_torch from")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("batch_invariance: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or REPO)
    sys.path.insert(0, root)
    from world_tpu_torch.parallel import pipeline
    from world_tpu_torch.tools.ola_bench import card_name

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    results = compare(pipeline, corpus_signals())
    lines = [{"root": root, "card": card, **d} for d in results]
    lines.append({"root": root, "card": card, "max": {
        how: {k: max(d[how][k] for d in results)
              for k in ("f0", "coded_sp", "coded_ap")}
        for how in ("rolled", "alone")}})
    with open(args.out, "a") if args.out else open(os.devnull, "w") as out:
        for line in lines:
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
