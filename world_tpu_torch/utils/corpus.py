"""Corpus-scale analysis jobs: checkpoint/resume, retries, metrics (port
of world_tpu/utils/corpus.py).

The reference's failure handling is wav-header validation and the
streaming deadlock detector; its persistence is the tagged parameter
files (reference tools/parameterio.cpp).  At corpus scale the job runner
records completed utterances so a preempted run resumes where it left
off, retries transient per-utterance failures, and reports structured
throughput metrics (frames/s, aggregate real-time factor) per shard.

The batched runner is the production path: the native threaded wav
loader, double-buffered dispatch on the card, a background writer pool,
and an optional on-card codec + float32 npz output format that shrinks
both the copied bytes and the files ~10-40x against the float64
reference-format triple.
"""

import json
import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import config
from ..device import download, resolve_device, upload


class CorpusCheckpoint:
    """Append-only JSONL record of completed utterances."""

    def __init__(self, path):
        self.path = path
        self.done = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self.done[rec["utterance"]] = rec

    def is_done(self, utterance):
        return utterance in self.done

    def mark(self, utterance, **info):
        rec = {"utterance": utterance, "time": time.time(), **info}
        self.done[utterance] = rec
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class CorpusRunner:
    """Analyze a list of wav files into tagged parameter files on
    ``device`` (the GPU unless given).

    Per-utterance failures are retried ``max_retries`` times, then
    recorded as failed (the job continues).  Completed work is skipped
    on resume via the checkpoint.
    """

    def __init__(self, out_dir, frame_period=5.0, f0_method="dio",
                 rng_mode="fast", max_retries=2, checkpoint=None,
                 log=print, device=None):
        self.out_dir = out_dir
        self.frame_period = frame_period
        self.f0_method = f0_method
        self.rng_mode = rng_mode
        self.max_retries = max_retries
        self.device = resolve_device(device)
        os.makedirs(out_dir, exist_ok=True)
        self.checkpoint = CorpusCheckpoint(
            checkpoint or os.path.join(out_dir, "checkpoint.jsonl"))
        self.log = log

    def _write_utt(self, stem, f0, sp, ap, fs, fft_size):
        """Write one utterance's parameters (f64 reference format;
        subclasses may emit the compact npz form instead)."""
        from ..io.parameterio import (write_aperiodicity, write_f0,
                                      write_spectral_envelope)
        write_f0(stem + ".f0", np.asarray(f0, np.float64),
                 self.frame_period)
        write_spectral_envelope(stem + ".sp", np.asarray(sp, np.float64),
                                fs, self.frame_period, fft_size)
        write_aperiodicity(stem + ".ap", np.asarray(ap, np.float64),
                           fs, self.frame_period, fft_size)

    def _process_one(self, wav_path):
        from .. import analyze
        from ..io.audio import wavread

        x, fs, _ = wavread(wav_path)
        params = analyze(x, fs, self.frame_period, f0_method=self.f0_method,
                         rng_mode=self.rng_mode, device=self.device)
        stem = os.path.join(
            self.out_dir,
            os.path.splitext(os.path.basename(wav_path))[0])
        self._write_utt(stem, params.f0.cpu().numpy(),
                        params.spectrogram.cpu().numpy(),
                        params.aperiodicity.cpu().numpy(), fs,
                        params.fft_size)
        return len(x) / fs, params.f0.shape[0]

    def _metrics(self, t_start, audio_seconds, frames, n_done, n_skipped,
                 n_failed, **extra):
        wall = time.time() - t_start
        metrics = {
            "utterances_done": n_done,
            "utterances_skipped": n_skipped,
            "utterances_failed": n_failed,
            "audio_seconds": round(audio_seconds, 3),
            "frames": frames,
            "wall_seconds": round(wall, 3),
            "frames_per_second": round(frames / wall, 1) if wall else 0.0,
            "realtime_factor": round(audio_seconds / wall, 2) if wall
            else 0.0,
            **extra,
        }
        self.log(f"[corpus] {json.dumps(metrics)}")
        return metrics

    def run(self, wav_paths):
        """Returns a metrics dict; individual failures are recorded, not
        raised."""
        t_start = time.time()
        audio_seconds = 0.0
        frames = 0
        n_done = n_skipped = n_failed = 0
        for path in wav_paths:
            key = os.path.basename(path)
            if self.checkpoint.is_done(key):
                n_skipped += 1
                continue
            err = None
            for attempt in range(self.max_retries + 1):
                try:
                    secs, nf = self._process_one(path)
                    self.checkpoint.mark(key, status="ok", seconds=secs,
                                         frames=nf)
                    audio_seconds += secs
                    frames += nf
                    n_done += 1
                    err = None
                    break
                except Exception as e:  # noqa: BLE001 — retry then record
                    err = f"{type(e).__name__}: {e}"
                    self.log(f"[corpus] {key} attempt {attempt + 1} "
                             f"failed: {err}")
                    traceback.print_exc()
            if err is not None:
                self.checkpoint.mark(key, status="failed", error=err)
                n_failed += 1
        return self._metrics(t_start, audio_seconds, frames, n_done,
                             n_skipped, n_failed)


class BatchedCorpusRunner(CorpusRunner):
    """Corpus analysis through the batched step.

    Wavs are bucketed by padded length (one step per bucket) and
    analyzed ``batch_size`` at a time in float32 fast mode, the
    production path.  Parameter files, checkpointing and retries behave
    like the per-file runner's; frames beyond each utterance's true
    length are cropped before writing.  A row's fast-mode draws do not
    depend on the other rows of its batch, so a resumed run, which
    regroups what is left, writes what an uninterrupted one would, up to
    the rounding of cuFFT and reductions at another batch size.

    Host side:

    - wav reading through the native multithreaded batch loader
      (native/worldio.cpp via io/native.py; Python fallback, reported as
      ``loader`` in the metrics);
    - double-buffered dispatch: batch k is launched on the card before
      batch k-1's results are read, so at most two batches are in
      flight; each batch's outputs are copied to pinned host memory
      behind a CUDA event (device.download);
    - file writes run on a background writer pool;
    - ``output_format="npz"`` stores float32 arrays (np.savez) instead
      of the f64 tagged triple; with ``codec_dims`` set the step also
      codes sp/ap on the card (models/codec.py), so no (B,F,fft/2+1)
      tensor is copied to the host.  io.parameterio.load_npz_parameters
      restores full-resolution parameters from either npz flavor.
    """

    def __init__(self, out_dir, fs=None, bucket_sizes=None, batch_size=16,
                 frame_period=5.0, f0_method="harvest", mesh=None,
                 output_format="ref", codec_dims=None, writer_threads=2,
                 bucket_seconds=None, **kw):
        """``fs``+``bucket_sizes`` (samples) pin the whole corpus to one
        rate (files at any other rate are recorded as failures).
        ``fs=None`` with ``bucket_seconds`` (durations) handles a
        MIXED-RATE corpus: each file runs at its own header rate, with
        per-(fs, length) steps and per-rate fft sizes — the reference's
        per-file fs handling (tools/audioio.cpp:217-252) at batch
        scale."""
        if mesh is not None:
            raise NotImplementedError("mesh sharding is not ported yet")
        super().__init__(out_dir, frame_period=frame_period,
                         f0_method=f0_method, **kw)
        if output_format not in ("ref", "npz"):
            raise ValueError(f"unknown output_format {output_format!r}")
        if codec_dims is not None and output_format != "npz":
            raise ValueError("codec_dims requires output_format='npz' "
                             "(the tagged reference format stores "
                             "full-resolution sp/ap)")
        if (fs is None) == (bucket_sizes is not None):
            raise ValueError("pass fs+bucket_sizes (single-rate) or "
                             "fs=None with bucket_seconds (mixed-rate)")
        if fs is None and not bucket_seconds:
            raise ValueError("mixed-rate corpus needs bucket_seconds")
        self.fs = fs
        self.bucket_sizes = sorted(bucket_sizes) if bucket_sizes else None
        self.bucket_seconds = sorted(bucket_seconds) if bucket_seconds \
            else None
        self.batch_size = batch_size
        self.output_format = output_format
        self.codec_dims = codec_dims
        self.writer_threads = writer_threads
        self.loader = None

    def _step_for(self, fs, length):
        from ..parallel.pipeline import get_batch_step
        return get_batch_step(
            fs, length, frame_period=self.frame_period,
            rng_mode=self.rng_mode, f0_method=self.f0_method,
            with_synthesis=False, codec_dims=self.codec_dims,
            device=self.device)

    def _write_utt(self, stem, f0, sp, ap, fs, fft_size, coded=False):
        """``coded``: sp/ap are device-coded (codec_dims columns), set
        by the batched call site — inferring it from the column count
        would mis-file a full-resolution fallback whenever
        fft_size//2+1 <= codec_dims."""
        if self.output_format == "ref":
            return super()._write_utt(stem, f0, sp, ap, fs, fft_size)
        from ..io.parameterio import write_npz
        if coded:
            write_npz(stem + ".npz", f0, fs, self.frame_period, fft_size,
                      coded_sp=sp, coded_ap=ap)
        else:
            # the per-file fallback path delivers full-resolution arrays
            write_npz(stem + ".npz", f0, fs, self.frame_period, fft_size,
                      spectrogram=sp, aperiodicity=ap)
        return None

    def _load_rows(self, batch_paths, length, fs):
        """Read a batch of wavs into padded float32 rows via the native
        threaded loader.  Returns (rows, lengths, failed_row_indices)."""
        from ..io.native import load_batch
        rows, lengths, got_fs, failed, self.loader = load_batch(
            batch_paths, length)
        ok = [i for i in range(len(batch_paths)) if i not in failed]
        if ok and got_fs and got_fs != fs:
            raise ValueError(f"fs {got_fs} != bucket fs {fs}")
        return rows, lengths, failed

    def _dispatch(self, step, rows):
        """Launch ``step`` on a batch and start copying its f0/sp/ap to
        the host.  Returns (host tensors, CUDA event or None)."""
        out = step(upload(rows, torch.float32, self.device))
        return download(out[:3], self.device)

    def run(self, wav_paths):
        from ..io.audio import peek_header

        t_start = time.time()
        audio_seconds = 0.0
        frames = 0
        n_done = n_skipped = n_failed = 0
        self.loader = None
        write_futures = []

        # ---- assign buckets from wav headers only (cheap peek) --------
        buckets = {}  # (fs, bucket_len) -> list of paths
        for p in wav_paths:
            key = os.path.basename(p)
            if self.checkpoint.is_done(key):
                n_skipped += 1
                continue
            try:
                n, fs = peek_header(p)
                if self.fs is not None:
                    if fs != self.fs:
                        raise ValueError(
                            f"fs {fs} != runner fs {self.fs}")
                    sizes = self.bucket_sizes
                else:  # mixed-rate: per-fs sample buckets from seconds
                    sizes = [int(np.ceil(s * fs))
                             for s in self.bucket_seconds]
                b = next((b for b in sizes if n <= b), None)
                if b is None:
                    raise ValueError(
                        f"{n} samples exceeds largest bucket")
            except Exception as e:  # noqa: BLE001 — recorded per-file
                # (a malformed wav can also raise struct.error etc.;
                # the contract is record-and-continue, never abort)
                self.checkpoint.mark(key, status="failed",
                                     error=f"{type(e).__name__}: {e}")
                n_failed += 1
                continue
            buckets.setdefault((fs, b), []).append(p)

        def write_one(stem, key, fs, fft_size, f0r, spr, apr, secs, nf):
            try:
                self._write_utt(stem, f0r, spr, apr, fs, fft_size,
                                coded=self.codec_dims is not None)
                return (key, "ok", secs, nf, None)
            except Exception as e:  # noqa: BLE001 — recorded per-file
                return (key, "failed", secs, nf,
                        f"{type(e).__name__}: {e}")

        def complete(pending, writer_pool):
            """Read a dispatched batch's results (retrying the step on
            failure, falling back to the per-file runner if it keeps
            failing) and queue the file writes."""
            nonlocal audio_seconds, frames, n_done, n_failed
            handles, rows, fs, length, batch_paths, lengths = pending
            step = self._step_for(fs, length)
            out = None
            # A step that raises is retried like the per-file runner's
            # utterances; a batch that keeps failing falls back to the
            # per-file path for its utterances, so one bad batch cannot
            # abort the run.  Launches are asynchronous, so a failure of
            # the already-launched batch surfaces at the event here;
            # retries launch and wait at once.  A launch that already
            # raised consumed attempt 0.  Only a Python exception from
            # the step or the read is retryable: a sticky CUDA error (an
            # illegal address, say) leaves the process's CUDA context
            # unusable, so its retries and the fallback fail alike.
            first = 1 if handles is None else 0
            for attempt in range(first, self.max_retries + 1):
                try:
                    if handles is None:
                        handles = self._dispatch(step, rows)
                    host, event = handles
                    if event is not None:
                        event.synchronize()
                    out = [h.numpy() for h in host]
                    break
                except Exception as e:  # noqa: BLE001 — retry/fall back
                    handles = None
                    self.log(f"[corpus] batch step (len {length}) "
                             f"attempt {attempt + 1} failed: "
                             f"{type(e).__name__}: {e}")
            if out is None:
                m = CorpusRunner.run(
                    self, [p for i, p in enumerate(batch_paths)
                           if lengths[i] > 0])
                n_done += m["utterances_done"]
                n_failed += m["utterances_failed"]
                audio_seconds += m["audio_seconds"]
                frames += m["frames"]
                return
            f0b, spb, apb = out
            fft_size = config.get_fft_size_for_cheaptrick(fs)
            for row, p in enumerate(batch_paths):
                true_len = int(lengths[row])
                if true_len == 0:
                    continue  # load failure, already recorded
                nf = config.get_samples_for_dio(
                    fs, true_len, self.frame_period)
                stem = os.path.join(self.out_dir, os.path.splitext(
                    os.path.basename(p))[0])
                write_futures.append(writer_pool.submit(
                    write_one, stem, os.path.basename(p), fs, fft_size,
                    f0b[row][:nf], spb[row][:nf], apb[row][:nf],
                    true_len / fs, nf))

        with ThreadPoolExecutor(self.writer_threads) as writer_pool:
            # ---- double-buffered dispatch loop ------------------------
            inflight = None
            for fs, length in sorted(buckets):
                paths_b = buckets[(fs, length)]
                step = self._step_for(fs, length)
                for b0 in range(0, len(paths_b), self.batch_size):
                    batch_paths = paths_b[b0: b0 + self.batch_size]
                    try:
                        rows, lengths, failed = self._load_rows(
                            batch_paths, length, fs)
                    except Exception as e:  # noqa: BLE001 — whole batch
                        for p in batch_paths:
                            self.checkpoint.mark(
                                os.path.basename(p), status="failed",
                                error=f"{type(e).__name__}: {e}")
                            n_failed += 1
                        continue
                    for i in failed:
                        self.checkpoint.mark(
                            os.path.basename(batch_paths[i]),
                            status="failed",
                            error=f"load failed ({self.loader} batch "
                                  "loader)")
                        n_failed += 1
                    if len(rows) < self.batch_size:
                        rows = np.concatenate([rows, np.zeros(
                            (self.batch_size - len(rows), length),
                            np.float32)])
                    try:
                        handles = self._dispatch(step, rows)
                    except Exception as e:  # noqa: BLE001 — retried later
                        handles = None
                        self.log(f"[corpus] batch dispatch (fs {fs}, len "
                                 f"{length}, offset {b0}) failed: "
                                 f"{type(e).__name__}: {e}")
                    if inflight is not None:
                        complete(inflight, writer_pool)
                    inflight = (handles, rows, fs, length, batch_paths,
                                lengths)
            if inflight is not None:
                complete(inflight, writer_pool)

            # ---- drain writers, record checkpoint marks ----------------
            for fut in write_futures:
                key, status, secs, nf, err = fut.result()
                if status == "ok":
                    self.checkpoint.mark(key, status="ok", seconds=secs,
                                         frames=nf)
                    audio_seconds += secs
                    frames += nf
                    n_done += 1
                else:
                    self.checkpoint.mark(key, status="failed", error=err)
                    n_failed += 1

        return self._metrics(t_start, audio_seconds, frames, n_done,
                             n_skipped, n_failed, loader=self.loader)
