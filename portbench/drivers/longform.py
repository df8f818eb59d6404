"""Long recordings through ``parallel.longform.analyze_long`` (halo-padded
chunks as rows of the batch step, ``batch_lanes`` rows a batch, two
batches in flight, host stitching of the full-resolution f0, sp and ap),
closed loop: a request is one int16 recording, the next sent when the
last one's whole result is on the host.

Request ``i`` is a recording of its own, made from (``--seed``, i).  A
loader thread makes the next while the current one runs, as a runner
reads its next file: the window holds the program's work, not the
making of its inputs.  The check re-derives the chunking (``chunking``)
and holds sampled chunks' core frames of the stitched result against
the reference on the chunk's own padded row.
"""

import concurrent.futures
import contextlib
import math
import time

import numpy as np

from .. import check, traffic
from ..reference.world import config as ref_config


def chunking(n, fs, frame_period, chunk_s, halo_s):
    """analyze_long's geometry for ``n`` samples, worked out again:
    (chunk length, core frames, first global frame of each chunk, first
    sample of each chunk, frames in all)."""
    fp_s = frame_period / 1000.0
    n_frames = ref_config.get_samples_for_dio(fs, n, frame_period)
    halo_f = int(math.ceil(halo_s / fp_s))
    core_f = max(1, int(round(chunk_s / fp_s)))
    chunk_len = int(math.ceil((core_f + 2 * halo_f - 1) * fp_s * fs)) + 1
    n_chunks = max(1, int(math.ceil(n_frames / core_f)))
    starts_f = np.arange(n_chunks) * core_f - halo_f
    starts = np.round(starts_f * fp_s * fs).astype(np.int64)
    return chunk_len, core_f, starts_f, starts, n_frames


class Driver:
    """``fault``, for the tests only: "half" leaves the second half of
    each recording out, "alter" alters every F0 of the result."""

    def __init__(self, cell, config, seed, device, fault=None):
        self.cell, self.config, self.seed = cell, config, seed
        self.mix = cell["traffic"]
        self.device, self.fault = device, fault

    def setup(self):
        import torch

        from world_tpu_torch.parallel.longform import analyze_long

        self.torch, self.analyze_long = torch, analyze_long
        self.dev = torch.device(self.device)
        fs = self.fs = self.config["fs"]
        t0 = time.perf_counter()
        self.loader = concurrent.futures.ThreadPoolExecutor(1)
        warm = self.recording(-1)
        self.phases = {"inputs_s": time.perf_counter() - t0}
        self.geometry = chunking(len(warm), fs,
                                 self.config["frame_period_ms"],
                                 self.mix["chunk_s"], self.mix["halo_s"])
        self.to_check = self.sample()
        self.next = self.loader.submit(self.recording, 0)
        t0 = time.perf_counter()
        # Every recording has one length, so one request runs every shape.
        self.call(warm)
        self.phases["warm_s"] = time.perf_counter() - t0
        self.phases["warm_requests"] = 1

    def recording(self, i):
        """Request ``i``'s recording (-1: the warm-up's)."""
        return traffic.recording(self.mix, self.fs, [self.seed, i + 1])

    def sample(self):
        """{request index: [chunks]}: requests drawn from the first
        ``horizon``, and in each the first chunk, the last and ``rows`` - 2
        others, drawn from the seed."""
        spec = self.cell["check"]
        rng = np.random.default_rng([self.seed, 1])
        n_chunks = len(self.geometry[2])
        picked = rng.choice(spec["horizon"], spec["batches"], replace=False)
        middle = rng.choice(np.arange(1, n_chunks - 1), spec["rows"] - 2,
                            replace=False)
        return {int(i): sorted({0, n_chunks - 1, *map(int, middle)})
                for i in picked}

    def call(self, x):
        if self.fault == "half":
            x = x.copy()
            x[len(x) // 2:] = 0
        c = self.config
        _, f0, sp, ap = self.analyze_long(
            x, self.fs, frame_period=c["frame_period_ms"],
            chunk_seconds=self.mix["chunk_s"],
            halo_seconds=self.mix["halo_s"], f0_method=c["f0_method"],
            rng_mode=c["rng_mode"], codec_dims=c["codec_dims"],
            batch_lanes=self.mix["batch_lanes"], device=self.dev)
        if self.fault == "alter":
            f0 = f0 * np.float32(1.002)
        return f0, sp, ap

    def window(self, seconds, tracer):
        torch = self.torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        t1 = t0 + seconds
        reqs, self.kept, self.inputs, i = [], {}, {}, 0
        waited = 0.0
        while time.perf_counter() < t1:
            t = time.perf_counter()
            x = self.next.result()
            waited += time.perf_counter() - t
            self.next = self.loader.submit(self.recording, i + 1)
            if tracer:
                tracer.begin(i)
            t = time.perf_counter()
            with (tracer.span("analyze_long") if tracer
                  else contextlib.nullcontext()):
                out = self.call(x)
            done = time.perf_counter()
            if tracer:
                tracer.done(i)
            reqs.append((t, done, len(x) / self.fs, (done - t) * 1e3))
            if i in self.to_check:
                self.kept[i], self.inputs[i] = out, x
            i += 1
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else None)
        self.next.cancel()
        self.loader.shutdown(wait=True)
        self.phases["loader_wait_s"] = waited
        for i in sorted(set(self.to_check) - set(self.kept)):
            self.inputs[i] = self.recording(i)
            self.kept[i] = self.call(self.inputs[i])
        return {"requests": reqs, "t0": t0, "t1": t1, "peak_bytes": peak}

    def release(self):
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def check_rows(self):
        """[(chunk row, its core frames, the stitched result on the chunk's
        local frames)] of the checked chunks: the core frames are the
        result's own; the halo frames, which no core of this chunk fills,
        come from the neighbours' cores (zero outside the signal)."""
        chunk_len, core_f, starts_f, starts, n_frames = self.geometry
        local_f = ref_config.get_samples_for_dio(
            self.fs, chunk_len, self.config["frame_period_ms"])
        for i, chunks in sorted(self.to_check.items()):
            x = self.inputs[i]
            f0, sp, ap = self.kept[i]
            for c in chunks:
                s0 = starts[c]
                row = np.zeros(chunk_len, np.float32)
                lo, hi = max(0, s0), min(len(x), s0 + chunk_len)
                row[lo - s0:hi - s0] = x[lo:hi].astype(np.float32) / 32768.0
                g = starts_f[c] + np.arange(local_f)
                ok = (g >= 0) & (g < n_frames)
                out = {}
                for k, v in (("f0", f0), ("sp", sp), ("ap", ap)):
                    local = np.zeros((local_f,) + v.shape[1:], v.dtype)
                    local[ok] = v[g[ok]]
                    out[k] = local
                core = (c * core_f - starts_f[c],
                        min(n_frames, (c + 1) * core_f) - starts_f[c])
                yield row, core, out

    def check(self, device, control=False):
        """Each number's worst checked chunk: the stitched result, or with
        ``control`` the control's outputs on the chunk's row."""
        return check.worst([
            check.judge_chunk(self.config, row, core,
                              check.control(self.config, row, device, False)
                              if control else out, device)
            for row, core, out in self.check_rows()])
