"""Batched analysis + synthesis step, sharded over a ('data', 'frame')
mesh (port of world_tpu/parallel/pipeline.py).

Utterances are padded/bucketed to fixed lengths on the host and run as
one batch: Dio -> StoneMask (or Harvest) -> CheapTrick -> D4C -> codec
-> Synthesis, each stage batched over the utterances.

The mesh is torch.distributed's, SPMD with one process per rank (the
JAX package's single-controller mesh drives every device from one
program; here each rank runs the same program on its own shard).  Every
rank calls the step with the same global batch.  Rows ride 'data'; the
F0 stage (sequential contour logic) rides 'data' only; StoneMask,
CheapTrick, D4C and the codec run on the rank's 1/n_frame slice of the
frames, each rank holding its rows' whole waveforms.  Synthesis couples
frames, so with it the rank's f0/sp/ap are all-gathered along 'frame'
once, in one packed buffer.  Collectives run on the process group's
backend: nccl for one rank per card, gloo on the CPU or for several
ranks on one card.
"""

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..device import StageClock, as_tensor, resolve_device, span
from ..models.cheaptrick import cheap_trick_batch
from ..models.codec import (code_aperiodicity_batch,
                            code_spectral_envelope_batch)
from ..models.d4c import d4c_batch
from ..models.dio import dio_batch
from ..models.harvest import harvest_batch
from ..models.stonemask import stone_mask_batch
from ..models.synthesis import synthesis_batch


def pad_and_bucket(waveforms, bucket_sizes):
    """Pad ragged utterances to the smallest admissible bucket length.

    Returns a dict bucket_length -> (stacked float32 array, lengths,
    indices), so each bucket runs as one batch shape.
    """
    buckets = {}
    for i, w in enumerate(waveforms):
        n = len(w)
        for b in sorted(bucket_sizes):
            if n <= b:
                buckets.setdefault(b, []).append((i, w))
                break
        else:
            raise ValueError(f"utterance {i} longer than largest bucket")
    out = {}
    for b, items in buckets.items():
        arr = np.zeros((len(items), b), np.float32)
        lengths = np.zeros(len(items), np.int32)
        idx = []
        for row, (i, w) in enumerate(items):
            arr[row, : len(w)] = w
            lengths[row] = len(w)
            idx.append(i)
        out[b] = (arr, lengths, np.asarray(idx))
    return out


def make_mesh(n_data=None, n_frame=1, devices=None):
    """A ('data', 'frame') DeviceMesh over the ranks of the default
    process group (join one first: utils.distributed.initialize).

    ``n_data`` defaults to world_size // n_frame; a world size other
    than n_data * n_frame raises ValueError.  ``devices`` is the device
    type the ranks compute on: None or "cuda" (the card; the process's
    current CUDA device), or "cpu", which needs a gloo group."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group; join one "
            "first with world_tpu_torch.utils.distributed.initialize")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_frame
    if n_data < 1 or n_frame < 1 or n_data * n_frame != world:
        raise ValueError(f"mesh ({n_data}, {n_frame}) does not cover the "
                         f"{world} ranks of the process group")
    device_type = "cuda" if devices is None else devices
    if device_type == "cuda":
        resolve_device(None)
    elif device_type != "cpu":
        raise ValueError(f"devices {devices!r}: expected 'cuda' or 'cpu'")
    elif dist.get_backend() != "gloo":
        raise ValueError("a CPU mesh needs a gloo process group, not "
                         f"{dist.get_backend()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_data, n_frame),
                            mesh_dim_names=("data", "frame"))


def mesh_shape(mesh):
    """(n_data, n_frame) of a mesh from make_mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) or \
            tuple(mesh.mesh_dim_names or ()) != ("data", "frame"):
        raise TypeError(f"expected a ('data', 'frame') DeviceMesh from "
                        f"make_mesh, got {mesh!r}")
    return mesh.size(0), mesh.size(1)


def mesh_device(mesh):
    """The torch.device this rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def step_device(mesh, device):
    """The device a step runs on: the mesh's when there is one (``device``
    must then name its type or be None), else resolve_device(device)."""
    if mesh is None:
        return resolve_device(device)
    mesh_shape(mesh)
    dev = mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device_type}")
    return dev


def frame_split(n_frames, n_frame, j):
    """Frame rank ``j``'s frames of ``n_frames`` padded to a multiple of
    ``n_frame``: (first frame, frames per rank, real frames)."""
    per = -(-n_frames // n_frame)
    return j * per, per, max(0, min(per, n_frames - j * per))


def make_batch_step(fs, x_length, frame_period=5.0, rng_mode="fast",
                    mesh=None, f0_method="dio", with_synthesis=True,
                    codec_dims=None, device=None):
    """Build a batched analysis(+synthesis) step on ``device`` (the GPU
    unless given; with a mesh, the mesh's device).

    Returns step(x_batch (B, x_length), timings=None) ->
    (f0 (B,F), sp (B,F,K), ap (B,F,K), y (B,y_length) or None).
    f0_method "dio" refines Dio's track with StoneMask; "harvest" runs
    Harvest.  With ``codec_dims`` set, sp and ap leave the step coded:
    sp as (B,F,codec_dims) mel-cepstrum, ap as (B,F,n_aper) coarse dB
    bands (synthesis still uses the full tensors).  with_synthesis=False
    skips resynthesis and returns y=None.  The batch's dtype rules
    (float32 is the production path).  Given a dict as ``timings``, the
    step synchronizes around each stage and records its wall
    milliseconds under the stage's name (parts of a stage as
    "<stage>.<part>").  The call is the span ``step``.

    With ``mesh`` (make_mesh), every rank calls the step with the same
    global batch, B a multiple of n_data, and gets its own shard: f0
    (B/n_data, F_r), sp/ap (B/n_data, F_r, ...), y (B/n_data, y_length),
    where F_r are the rank's frames of F padded to a multiple of n_frame
    (the pad dropped).  gather_outputs assembles the global tensors.  A
    shard computes what its frames compute unsharded: fast-mode dither
    is drawn for the whole utterance and sliced.  Frame sharding
    (n_frame > 1) requires rng_mode "fast" or "none" (exact mode
    consumes one sequential xorshift stream per utterance).
    """
    if f0_method not in ("dio", "harvest"):
        raise ValueError(f"f0_method {f0_method!r}")
    n_data, n_frame = (1, 1) if mesh is None else mesh_shape(mesh)
    if n_frame > 1 and rng_mode == "exact":
        raise ValueError("frame-axis sharding requires rng_mode 'fast' or "
                         "'none' (exact mode consumes one sequential "
                         "xorshift stream per utterance)")
    dev = step_device(mesh, device)
    if mesh is None:
        d_rank = f_rank = 0
        frame_group = None
    else:
        d_rank = mesh.get_local_rank("data")
        f_rank = mesh.get_local_rank("frame")
        frame_group = mesh.get_group("frame")
    option = config.CheapTrickOption().resolve(fs)
    fft_size = option.fft_size
    f0_length = config.get_samples_for_dio(fs, x_length, frame_period)
    y_length = int((f0_length - 1) * frame_period / 1000.0 * fs) + 1
    f_lo, f_per, f_real = frame_split(f0_length, n_frame, f_rank)
    frames = None if n_frame == 1 else (f_lo, f0_length)

    def f0_stage(x, clock):
        """Each row's time axis and F0 track (Dio's unrefined: StoneMask
        runs on the frame shard)."""
        if f0_method == "harvest":
            with clock("harvest"):
                tp, f0 = harvest_batch(x, fs, frame_period,
                                       config.K_FLOOR_F0, config.K_CEIL_F0,
                                       clock=clock)
        else:
            with clock("dio"):
                tp, f0 = dio_batch(x, fs, frame_period, config.K_FLOOR_F0,
                                   config.K_CEIL_F0, channels_in_octave=2.0,
                                   speed=1, allowed_range=0.1, clock=clock)
        return tp.expand_as(f0), f0

    def frame_shard(tp, f0):
        """This rank's frames: F padded to a multiple of n_frame (tp
        edge-padded, f0 zero-padded), then the rank's slice."""
        if n_frame == 1:
            return tp, f0
        pad = f_per * n_frame - f0_length
        if pad:
            tp = torch.cat([tp, tp[:, -1:].expand(-1, pad)], 1)
            f0 = torch.nn.functional.pad(f0, (0, pad))
        return (tp[:, f_lo:f_lo + f_per].contiguous(),
                f0[:, f_lo:f_lo + f_per].contiguous())

    def gather_frames(f0, sp, ap):
        """The rows' whole f0/sp/ap from every frame rank's slice: one
        all_gather of the packed (rows, frames, 2K+1) buffer."""
        if n_frame == 1:
            return f0, sp, ap
        k = sp.shape[-1]
        packed = torch.cat([f0[..., None], sp, ap], -1).contiguous()
        parts = [torch.empty_like(packed) for _ in range(n_frame)]
        dist.all_gather(parts, packed, group=frame_group)
        whole = torch.cat(parts, 1)[:, :f0_length]
        return (whole[..., 0].contiguous(),
                whole[..., 1:k + 1].contiguous(),
                whole[..., k + 1:].contiguous())

    def run(x_batch, timings):
        x = as_tensor(x_batch, dev)
        if x.dim() != 2 or x.shape[1] != x_length:
            raise ValueError(f"expected (B, {x_length}), got "
                             f"{tuple(x.shape)}")
        if n_data > 1:
            if x.shape[0] % n_data:
                raise ValueError(f"batch {x.shape[0]} is not a multiple "
                                 f"of the mesh's data axis ({n_data})")
            rows = x.shape[0] // n_data
            x = x[d_rank * rows:(d_rank + 1) * rows]
        clock = StageClock(timings, dev)
        tp, f0 = frame_shard(*f0_stage(x, clock))
        if f0_method == "dio":
            with clock("stonemask"):
                f0 = stone_mask_batch(x, fs, tp, f0)
        with clock("cheaptrick"):
            sp = cheap_trick_batch(x, tp, f0, fs, fft_size, q1=option.q1,
                                   rng_mode=rng_mode, frames=frames)
        with clock("d4c"):
            ap = d4c_batch(x, tp, f0, fs, fft_size,
                           threshold=config.K_THRESHOLD, rng_mode=rng_mode,
                           frames=frames)
        sp_out, ap_out = sp, ap
        if codec_dims is not None:
            with clock("codec"):
                sp_out = code_spectral_envelope_batch(sp, fs, fft_size,
                                                      codec_dims)
                ap_out = code_aperiodicity_batch(ap, fs, fft_size)
        y = None
        if with_synthesis:
            with clock("synthesis"):
                y = synthesis_batch(*gather_frames(f0, sp, ap), fs,
                                    frame_period, y_length, fft_size,
                                    rng_mode=rng_mode)
        if n_frame > 1:
            f0, sp_out, ap_out = (t[:, :f_real] for t in (f0, sp_out,
                                                          ap_out))
        return f0, sp_out, ap_out, y

    def step(x_batch, timings=None):
        with span("step"):
            return run(x_batch, timings)

    return step


def gather_outputs(outputs, mesh):
    """The global tensors of a sharded step's outputs (f0, sp, ap, y):
    f0 (B, F), sp/ap (B, F, ...), y (B, y_length), assembled on every
    rank of ``mesh`` (the counterpart of reading a JAX global array).
    Every rank must call it."""
    n_data, n_frame = mesh_shape(mesh)

    def all_gather(t, axis, n):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
        return parts

    def over_frames(t):
        if n_frame == 1:
            return t
        sizes = [int(n) for n in all_gather(
            torch.tensor([t.shape[1]], device=t.device), "frame", n_frame)]
        pad = (0, 0) * (t.dim() - 2) + (0, max(sizes) - t.shape[1])
        parts = all_gather(torch.nn.functional.pad(t, pad), "frame",
                           n_frame)
        return torch.cat([p[:, :n] for p, n in zip(parts, sizes)], 1)

    def over_rows(t):
        if n_data == 1 or t is None:
            return t
        return torch.cat(all_gather(t, "data", n_data), 0)

    f0, sp, ap, y = outputs
    return (*(over_rows(over_frames(t)) for t in (f0, sp, ap)),
            over_rows(y))


def run_global(step, x, mesh):
    """``step(x)`` for a batch of any row count: on a mesh, ``x`` padded
    with zero rows to a multiple of n_data, the shards gathered and the
    pad rows cut, so every rank gets the global outputs."""
    if mesh is None:
        return step(x)
    n, n_data = x.shape[0], mesh_shape(mesh)[0]
    if n % n_data:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_data - n % n_data))
    return tuple(None if t is None else t[:n]
                 for t in gather_outputs(step(x), mesh))


_STEP_CACHE = {}
# A leak backstop for long-lived processes sweeping many shapes.
_STEP_CACHE_MAX = 64


def get_batch_step(fs, x_length, frame_period=5.0, rng_mode="fast",
                   mesh=None, f0_method="dio", with_synthesis=True,
                   codec_dims=None, device=None):
    """Memoized make_batch_step.  A mesh keys its steps by identity as
    well as by its (stable) hash: an equal mesh built on a later process
    group gets steps of its own."""
    dev = step_device(mesh, device)
    key = (fs, x_length, frame_period, rng_mode, mesh, id(mesh), f0_method,
           with_synthesis, codec_dims, str(dev))
    if key not in _STEP_CACHE:
        while len(_STEP_CACHE) >= _STEP_CACHE_MAX:
            _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
        _STEP_CACHE[key] = make_batch_step(
            fs, x_length, frame_period=frame_period, rng_mode=rng_mode,
            mesh=mesh, f0_method=f0_method, with_synthesis=with_synthesis,
            codec_dims=codec_dims, device=dev)
    return _STEP_CACHE[key]


def corpus_metrics(f0_batch, lengths, fs, frame_period):
    """Corpus-level reductions of a batch: voiced frames, mean F0 over
    them, audio seconds.  Returns 0-dim tensors."""
    f0_batch = torch.as_tensor(f0_batch)
    voiced = f0_batch > 0
    n_voiced = voiced.sum()
    return {
        "voiced_frames": n_voiced,
        "mean_f0": torch.where(voiced, f0_batch,
                               torch.zeros_like(f0_batch)).sum()
        / n_voiced.clamp(min=1),
        "audio_seconds": torch.as_tensor(lengths).sum().to(torch.float64)
        / fs,
    }
