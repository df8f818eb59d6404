"""Many listeners through world_tpu_torch's ``StreamingSynthesizer``, as
a server that feeds them all from one thread: WORLD's real-time mode
(test/test.cpp:300-339: one frame an ``add_parameters``, ``synthesis2``
drained buffer by buffer) on ``lanes`` synthesizers at once, closed loop.

Set-up.  A pool of ``utterances`` signals of the mix (traffic.py, the
lengths of harvest_22k's corpus) is analysed by the port's batch step
under the configuration's analysis settings, and the pool's f0, sp and
ap stay on the card, where an acoustic model would leave them; ``--seed``
draws the signals and the order in which the lanes take the utterances,
cycled.  Then one synthesizer's ``warmup()`` (cuFFT's plans are
process-wide) and a warm-up of the loop itself, until every lane has
delivered ``warm_buffers`` buffers.

The loop visits the lanes round-robin.  A visit pushes the lane's next
frame if the ring takes it, then calls ``synthesis2()`` until it returns
False (test.cpp's loop; with ``hold_on_miss`` a held window returns False
too).  A lane whose utterance has delivered its last buffer (every frame
pushed, and the next window past the last pulse) refreshes its
synthesizer and starts the next utterance at once, bringing its frames
to the host.

A request is one buffer: dispatched at the first ``synthesis2`` call made
for it, done when a call returns it; its audio is its samples within the
utterance's length.  A buffer asked for in the window is finished after
it, as the other drivers finish the requests in flight.
"""

import time

import numpy as np

from .. import check, check_stream, traffic
from ..reference import realtime as ref_realtime


class Lane:
    def __init__(self, index, synth):
        self.index, self.synth = index, synth
        self.total = 0            # buffers delivered since set-up
        self.asked = None         # first call made for the next buffer
        self.segment = None       # the checked buffers of this utterance


class Segment:
    """A checked lane's buffers of one utterance delivered in the window,
    from its ``j0``-th on."""

    def __init__(self, frames, j0):
        self.frames, self.j0 = frames, j0
        self.buffers, self.finished = [], False


class Driver:
    """``fault``, for the tests only, breaks what a checked listener
    receives: "drop" loses its third buffer of the window, "swap" swaps
    its third and fourth."""

    def __init__(self, cell, config, seed, device, fault=None):
        self.cell, self.config, self.seed = cell, config, seed
        self.mix = cell["traffic"]
        self.device, self.fault = device, fault
        self.fs = config["fs"]
        self.bs = config["buffer_size"]

    def setup(self):
        import torch

        from world_tpu_torch.device import download
        from world_tpu_torch.models.realtime import StreamingSynthesizer

        self.torch, self.download = torch, download
        self.dev = torch.device(self.device)
        c = self.config
        t0 = time.perf_counter()
        signals = traffic.corpus(self.mix, self.fs, self.seed)
        self.phases = {"inputs_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.pool = self.analyse(signals)
        self.order = np.random.default_rng([self.seed, 2]).permutation(
            len(self.pool))
        self.next_k = 0
        self.phases["analysis_s"] = time.perf_counter() - t0
        self.lanes = [Lane(i, StreamingSynthesizer(
            self.fs, c["frame_period_ms"], c["fft_size"], self.bs,
            c["number_of_pointers"], rng_mode=c["rng_mode"],
            dtype=np.dtype(c["dtype"]), hold_on_miss=c["hold_on_miss"],
            dispatch_min_pulses=c["dispatch_min_pulses"],
            hold_force_ms=c["hold_force_ms"], device=self.dev))
            for i in range(self.mix["lanes"])]
        if self.dev.type == "cuda":
            t0 = time.perf_counter()
            self.lanes[0].synth.warmup()
            self.phases["synth_warmup_s"] = time.perf_counter() - t0
        rng = np.random.default_rng([self.seed, 1])
        self.to_check = sorted(int(rng.choice(part)) for part in
                               np.array_split(np.arange(len(self.lanes)),
                                              self.cell["check"]["lanes"]))
        t0 = time.perf_counter()
        self.requests, self.tracer, self.recording = [], None, False
        self.t1 = None
        for lane in self.lanes:
            self.start(lane)
        while min(lane.total for lane in self.lanes) \
                < self.mix["warm_buffers"]:
            for lane in self.lanes:
                self.visit(lane)
        self.phases["warm_s"] = time.perf_counter() - t0
        self.phases["warm_buffers"] = sum(lane.total for lane in self.lanes)

    def analyse(self, signals):
        """The pool: [(f0, sp, ap) of each utterance's real frames, views
        of the batch step's outputs on the device]."""
        from world_tpu_torch.device import upload
        from world_tpu_torch.parallel.pipeline import get_batch_step

        torch, c = self.torch, self.config
        pool = [None] * len(signals)
        for rows, _, members in traffic.batches(signals, self.mix, self.fs):
            step = get_batch_step(
                self.fs, rows.shape[1], frame_period=c["frame_period_ms"],
                rng_mode=c["rng_mode"], f0_method=c["f0_method"],
                with_synthesis=False, device=self.dev)
            f0, sp, ap, _ = step(upload(rows, torch.float32, self.dev))
            for r, i in enumerate(members):
                n = check.real_frames(self.fs, len(signals[i]))
                pool[i] = (f0[r, :n], sp[r, :n], ap[r, :n])
        return pool

    def start(self, lane):
        """Lane ``lane`` takes the next utterance of the cycled pool."""
        u = int(self.order[self.next_k % len(self.order)])
        self.next_k += 1
        host, event = self.download(self.pool[u], self.dev)
        if event is not None:
            event.synchronize()
        lane.frames = [h.numpy() for h in host]
        lane.n_frames = len(lane.frames[0])
        lane.length = int((lane.n_frames - 1)
                          * self.config["frame_period_ms"] / 1000.0
                          * self.fs) + 1
        lane.fed = lane.delivered = 0
        lane.asked = None
        if self.recording and lane.index in self.to_check:
            lane.segment = Segment(lane.frames, 0)
            self.segments[lane.index].append(lane.segment)

    def visit(self, lane):
        s, bs = lane.synth, self.bs
        if lane.fed < lane.n_frames:
            k = lane.fed
            f0, sp, ap = lane.frames
            if s.add_parameters(f0[k:k + 1], sp[k:k + 1], ap[k:k + 1]):
                lane.fed += 1
        while True:
            t = time.perf_counter()
            if lane.asked is None:
                lane.asked = t
            if not s.synthesis2():
                break
            self.delivered(lane, t, time.perf_counter())
        if lane.fed == lane.n_frames \
                and s.synthesized_sample + bs >= s.last_location:
            if lane.segment is not None:
                lane.segment.finished = True
                lane.segment = None
            s.refresh()
            self.start(lane)

    def delivered(self, lane, t_call, t_done):
        bs = self.bs
        audio = min(bs, max(0, lane.length - lane.delivered * bs)) / self.fs
        if self.t1 is not None and lane.asked <= self.t1:
            self.requests.append((lane.asked, t_done, audio,
                                  (t_done - t_call) * 1e3))
        if lane.segment is not None:
            lane.segment.buffers.append(lane.synth.buffer[:bs].copy())
            self.broken(lane.segment.buffers)
        lane.delivered += 1
        lane.total += 1
        lane.asked = None
        if self.tracer:
            self.tracer.done(self.n_done)
            self.n_done += 1
            self.tracer.begin(self.n_done)

    def broken(self, buffers):
        if self.fault == "drop" and len(buffers) == 3:
            buffers.pop()
            self.fault = "dropped"
        elif self.fault == "swap" and len(buffers) == 4:
            buffers[2], buffers[3] = buffers[3], buffers[2]
            self.fault = "swapped"

    def window(self, seconds, tracer):
        """The measured window.  Returns {"requests": [(t_dispatch,
        t_done, audio_s, call_ms)] of every buffer asked for in it, "t0",
        "t1", "peak_bytes"}."""
        torch = self.torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        renders0 = sum(lane.synth.renders for lane in self.lanes)
        self.segments = {i: [] for i in self.to_check}
        for i in self.to_check:
            lane = self.lanes[i]
            lane.segment = Segment(lane.frames, lane.delivered)
            self.segments[i].append(lane.segment)
        self.recording, self.tracer, self.n_done = True, tracer, 0
        if tracer:
            tracer.begin(0)
        t0 = time.perf_counter()
        self.t1 = t1 = t0 + seconds
        started = self.next_k
        while time.perf_counter() < t1:
            for lane in self.lanes:
                self.visit(lane)
                if time.perf_counter() >= t1:
                    break
        # Finish the buffers asked for in the window, and a trace that
        # has not ended (its buffers past the window are not requests).
        while True:
            pending = [lane for lane in self.lanes
                       if lane.asked is not None and lane.asked <= t1]
            if tracer and tracer.prof is not None:
                pending = self.lanes
            if not pending:
                break
            for lane in pending:
                self.visit(lane)
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else None)
        self.recording, self.tracer = False, None
        for lane in self.lanes:
            lane.segment = None
        # Mean ms between completions in the window's first tenth and in
        # the rest: equal, nothing was left to warm.
        done = np.sort([r[1] for r in self.requests])
        gaps = np.diff(done)
        first = gaps[:len(gaps) // 10]
        later = gaps[len(gaps) // 10:]
        self.phases["first_pass_ms"] = float(first.mean() * 1e3) \
            if len(first) else None
        self.phases["later_ms"] = float(later.mean() * 1e3) \
            if len(later) else None
        self.phases["window_buffers"] = len(self.requests)
        self.phases["window_renders"] = sum(
            lane.synth.renders for lane in self.lanes) - renders0
        self.phases["window_utterances"] = self.next_k - started
        return {"requests": self.requests, "t0": t0, "t1": t1,
                "peak_bytes": peak}

    def release(self):
        """Drop the program's state before the reference runs."""
        for lane in self.lanes:
            lane.synth.close()
        self.lanes = self.pool = None
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, device, control=False):
        """Each number's worst checked lane: the delivered buffers, or
        with ``control`` the control's in their place."""
        import torch

        c = self.config
        refs = {}

        def reference(frames, dtype=torch.float64):
            return ref_realtime.stream(
                *frames, self.fs, c["frame_period_ms"], c["fft_size"],
                self.bs, rng_mode=c["rng_mode"], dtype=dtype, device=device)

        lanes = []
        for i in self.to_check:
            segments = []
            for seg in self.segments[i]:
                key = id(seg.frames[0])
                if key not in refs:
                    refs[key] = reference(seg.frames)
                y_ref, n_ref = refs[key]
                got = np.asarray(seg.buffers, np.float64).reshape(
                    -1, self.bs)
                if control:
                    got = self.control(reference, seg, len(got))
                segments.append((got, seg.j0, seg.finished, y_ref, n_ref))
            lanes.append(check_stream.judge_lane(segments, self.fs))
        return check.worst(lanes)

    def control(self, reference, seg, m):
        """The control's buffers j0 .. j0 + m - 1 of a segment: the
        reference in float32 from frames rounded to bfloat16, its output
        rounded to bfloat16."""
        import torch

        def bf16(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(
                torch.bfloat16).to(torch.float32).numpy()

        y, _ = reference([bf16(a) for a in seg.frames], torch.float32)
        y = np.concatenate([bf16(y).astype(np.float64),
                            np.zeros((seg.j0 + m) * self.bs)])
        return y[seg.j0 * self.bs:(seg.j0 + m) * self.bs].reshape(m, self.bs)
