"""The batch step as a corpus runner drives it: ``get_batch_step`` per
bucket, inputs up with ``device.upload``, outputs back with
``device.download``, ``in_flight`` batches in flight (the loop of
world_tpu_torch/utils/corpus.py's BatchedCorpusRunner), closed loop.

A request is one batch.  The corpus of the cell's mix (traffic.py) is
cycled in its batches' order for as long as the window lasts.
"""

import collections
import contextlib
import itertools
import time

import numpy as np

from .. import check, traffic


class Request:
    def __init__(self, i, batch, t_dispatch, host, event, step_ms):
        self.i, self.batch = i, batch
        self.t_dispatch, self.t_done = t_dispatch, None
        self.host, self.event, self.step_ms = host, event, step_ms


class Driver:
    """``cell``, ``config``: the parsed workload and configuration files;
    ``fault``, for the tests only, breaks the timed path: "half" leaves
    the second half of each batch's real rows out, "alter" alters every
    F0 where it is produced."""

    def __init__(self, cell, config, seed, device, fault=None):
        self.cell, self.config, self.seed = cell, config, seed
        self.mix = cell["traffic"]
        self.device, self.fault = device, fault
        self.outputs = (("f0", "sp", "ap", "y") if config["with_synthesis"]
                        else ("f0", "coded_sp", "coded_ap")
                        if config["codec_dims"] else ("f0", "sp", "ap"))

    def setup(self):
        import torch

        from world_tpu_torch.device import download, upload
        from world_tpu_torch.parallel.pipeline import get_batch_step

        self.torch, self.upload, self.download = torch, upload, download
        self.dev = torch.device(self.device)
        fs, c = self.config["fs"], self.config
        t0 = time.perf_counter()
        signals = traffic.corpus(self.mix, fs, self.seed)
        self.epoch = traffic.batches(signals, self.mix, fs)
        self.phases = {"inputs_s": time.perf_counter() - t0}
        self.fs = fs
        self.steps = {
            b: get_batch_step(fs, b, frame_period=c["frame_period_ms"],
                              rng_mode=c["rng_mode"], f0_method=c["f0_method"],
                              with_synthesis=c["with_synthesis"],
                              codec_dims=c["codec_dims"], device=self.dev)
            for b in sorted({rows.shape[1] for rows, _, _ in self.epoch})}
        self.to_check = self.sample()
        t0 = time.perf_counter()
        # Warm-up: the whole epoch once, so that every shape the window
        # meets has run: the buckets, and the sizes that follow each
        # batch's voicing (D4C's passing frames, synthesis's pulses),
        # whose FFT plans are made when first met.  The window then
        # cycles the epoch; its first pass against the later ones
        # (phases) shows that nothing is left to warm.
        self.loop(range(len(self.epoch)), None, None)
        self.phases["warm_s"] = time.perf_counter() - t0
        self.phases["warm_requests"] = len(self.epoch)

    def sample(self):
        """{request index: [rows]} to check, drawn from the seed: a
        request of the longest bucket and others among the first
        ``horizon``, and in each one real row from each of ``rows`` equal
        parts of the batch."""
        spec = self.cell["check"]
        rng = np.random.default_rng([self.seed, 1])
        n = len(self.epoch)
        horizon = range(spec["horizon"])
        longest = max(self.epoch[i % n][0].shape[1] for i in horizon)
        first = rng.choice([i for i in horizon
                            if self.epoch[i % n][0].shape[1] == longest])
        rest = [i for i in horizon if i != first]
        picked = [int(first)] + [int(i) for i in rng.choice(
            rest, spec["batches"] - 1, replace=False)]
        out = {}
        for i in picked:
            real = np.flatnonzero(self.epoch[i % n][1])
            out[i] = [int(rng.choice(part)) for part in
                      np.array_split(real, min(spec["rows"], len(real)))]
        return out

    def dispatch(self, i):
        torch = self.torch
        rows, lengths, _ = self.epoch[i % len(self.epoch)]
        t0 = time.perf_counter()
        x = self.upload(rows, torch.float32, self.dev)
        if self.fault == "half":
            real = int((lengths > 0).sum())
            x = x.clone()      # on the CPU, upload shares the host rows
            x[real // 2:real] = 0.0
        outs = self.steps[rows.shape[1]](x)
        if self.config["with_synthesis"]:
            outs = outs[:4]
        else:
            outs = outs[:3]
        if self.fault == "alter":
            outs = (outs[0] * 1.002,) + tuple(outs[1:])
        step_ms = (time.perf_counter() - t0) * 1e3
        host, event = self.download(outs, self.dev)
        return Request(i, rows, t0, host, event, step_ms)

    def loop(self, order, seconds, tracer):
        """Dispatch the requests of ``order`` (indices into the cycled
        epoch) until it ends or ``seconds`` have passed; returns (all
        requests, the window's end).  Requests still in flight then are
        finished after it."""
        inflight, done = collections.deque(), []
        t_end = None if seconds is None else time.perf_counter() + seconds
        span = tracer.span if tracer else _no_span
        for i in order:
            if len(inflight) == self.mix["in_flight"]:
                done.append(self.finish(inflight.popleft(), tracer, span))
            if t_end is not None and time.perf_counter() >= t_end:
                break
            if tracer:
                tracer.begin(i)
            with span("dispatch"):
                inflight.append(self.dispatch(i))
        while inflight:
            done.append(self.finish(inflight.popleft(), tracer, span))
        return done, t_end

    def finish(self, req, tracer, span):
        with span("wait_outputs"):
            if req.event is not None:
                req.event.synchronize()
        req.t_done = time.perf_counter()
        if req.i not in self.to_check:
            # Consumed, as a runner writes its outputs and lets them go:
            # the pinned buffers return to the host allocator's cache
            # instead of piling up over the window.
            req.host = None
        if tracer:
            tracer.done(req.i)
        return req

    def window(self, seconds, tracer):
        """The measured window.  Returns {"requests": [(t_dispatch,
        t_done, audio_s, step_ms)] of every request dispatched in it,
        "t0", "t1", "peak_bytes"}."""
        torch = self.torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        done, t1 = self.loop(itertools.count(), seconds, tracer)
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else None)
        self.kept = {}
        for r in done:
            if r.i in self.to_check:
                self.kept[r.i] = (r.batch, [h.numpy() for h in r.host])
        # A checked request the window did not reach runs now, outside it.
        for i in sorted(set(self.to_check) - set(self.kept)):
            r = self.finish(self.dispatch(i), None, _no_span)
            self.kept[i] = (r.batch, [h.numpy() for h in r.host])
        n = len(self.epoch)
        reqs = [(r.t_dispatch, r.t_done,
                 float(self.epoch[r.i % n][1].sum()) / self.fs, r.step_ms)
                for r in done]
        # Mean ms between completions in the epoch's first pass through
        # the window and in the later passes.
        gaps = np.diff([r.t_done for r in done])
        first = gaps[:n - 1]
        later = gaps[n - 1:]
        self.phases["first_pass_ms"] = float(first.mean() * 1e3) \
            if len(first) else None
        self.phases["later_ms"] = float(later.mean() * 1e3) \
            if len(later) else None
        return {"requests": reqs, "t0": t0, "t1": t1, "peak_bytes": peak}

    def release(self):
        """Drop the program's state before the reference runs."""
        self.steps = None
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def check_rows(self):
        """[(padded row, real length, {output: row's values})] of the
        checked rows."""
        n = len(self.epoch)
        for i, rows in sorted(self.to_check.items()):
            batch, host = self.kept[i]
            lengths = self.epoch[i % n][1]
            for r in rows:
                yield batch[r], int(lengths[r]), {
                    k: h[r] for k, h in zip(self.outputs, host)}

    def check(self, device, control=False):
        """Each number's worst checked row: the program's outputs, or with
        ``control`` the control's in their place."""
        syn = self.config["with_synthesis"]
        return check.worst([
            check.judge_row(self.config, x, n,
                            check.control(self.config, x, device, syn)
                            if control else out, device)
            for x, n, out in self.check_rows()])


def _no_span(name):
    return contextlib.nullcontext()
