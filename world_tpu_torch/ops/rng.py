"""Deterministic RNG matching the reference, plus fast-mode normals.

The reference uses xorshift128 with a fixed seed, summing 12 draws of
(w >> 4) to approximate N(0,1) (reference src/matlabfunctions.cpp:237-264),
and consumes that one stream sequentially across data-dependent block
sizes (one block per frame / per pulse).  The state update is linear
over GF(2), so jumping k draws ahead is a 128x128 bit-matrix power:
``states_at_draws`` lands any number of stream positions in parallel.

On the card a span of the stream is one launch of csrc/xorshift.cu
(``randn_span``: each lane's jump, its split among _DRAWERS threads and
the draws); on the CPU its plain
version runs the jump as a float32 matmul of 0/1 values (every sum is at
most 128, so exact), then ``% 2``, and the draws as a loop, the
xorshift words carried in int64 masked to 32 bits (torch.uint32 has few
operators).

Fast mode draws normals from an explicit ``torch.Generator``; a torch
generator cannot reproduce jax.random sample for sample, so fast-mode
results are held to envelope gates, not to the JAX output.
"""

import ctypes
import functools

import numpy as np
import torch

from . import _cuda

SEED = (123456789, 362436069, 521288629, 88675123)
_MASK = 0xFFFFFFFF
# Draws per parallel lane when a whole span of the stream is generated.
_LANE = 64
# Jump matrices M^(2^b), b < _MAX_LOG2: stream positions below 2^34.
_MAX_LOG2 = 34
# Threads of a lane's warp that draw its _LANE normals on the card, each
# from a jump of its own (_split_rows): csrc/xorshift.cu's kDrawers, which
# sets the table's layout (tests/test_torch_iir.py holds the two equal).
_DRAWERS = 8


def _state_step_bits(bits):
    """One state update acting on a 128-bit boolean vector (numpy)."""
    x = bits[0:32]
    y = bits[32:64]
    z = bits[64:96]
    w = bits[96:128]
    # t = x ^ (x << 11): bit i of t = x[i] ^ x[i-11]
    t = x.copy()
    t[11:] ^= x[:-11]
    # w' = (w ^ (w>>19)) ^ (t ^ (t>>8))
    wn = w.copy()
    wn[:-19] ^= w[19:]
    wn ^= t
    wn[:-8] ^= t[8:]
    out = np.empty(128, np.uint8)
    out[0:32] = y
    out[32:64] = z
    out[64:96] = w
    out[96:128] = wn
    return out


def _gf2_matmul(a, b):
    """Product of two 0/1 matrices over GF(2) (uint8)."""
    return (a.astype(np.int32) @ b.astype(np.int32) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _jump_matrices(max_log2=_MAX_LOG2):
    """M_draw^(2^b) for b in 0..max_log2-1, where M_draw = 12 state steps.
    (max_log2, 128, 128) uint8; next_bits = (bits @ M.T) & 1."""
    eye = np.eye(128, dtype=np.uint8)
    m_step = np.stack([_state_step_bits(eye[i]) for i in range(128)], axis=1)
    m_draw = eye
    for _ in range(12):
        m_draw = _gf2_matmul(m_step, m_draw)
    mats = np.empty((max_log2, 128, 128), np.uint8)
    mats[0] = m_draw
    for b in range(1, max_log2):
        mats[b] = _gf2_matmul(mats[b - 1], mats[b - 1])
    return mats


def _draw_jump(k):
    """M_draw^k (128, 128) uint8: the product of the jump matrices of k's
    set bits."""
    out = np.eye(128, dtype=np.uint8)
    for b in range(int(k).bit_length()):
        if (k >> b) & 1:
            out = _gf2_matmul(_jump_matrices()[b], out)
    return out


def _seed_bits():
    bits = np.zeros(128, np.float32)
    for word, val in enumerate(SEED):
        for b in range(32):
            bits[word * 32 + b] = (val >> b) & 1
    return bits


@functools.lru_cache(maxsize=None)
def _jump_tables(device):
    """The jump matrices (float32) and the seed's bits on ``device``,
    uploaded once per device."""
    return (torch.as_tensor(_jump_matrices(), dtype=torch.float32,
                            device=device),
            torch.as_tensor(_seed_bits(), device=device))


def states_at_draws(offsets, max_offset=None):
    """States (int64 (..., 4) holding uint32 words) positioned just before
    draw number ``offsets`` (0 = fresh seed).  ``max_offset``, when the
    caller knows it on the host, spares reading it from the device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = offsets.device
    offsets = offsets.to(torch.int64)
    if max_offset is None:
        max_offset = int(offsets.max()) if offsets.numel() else 0
    n_bits = max(1, int(max_offset).bit_length())
    jumps, seed = _jump_tables(dev)
    mats = jumps[:n_bits]
    bits = seed.expand(offsets.shape + (128,))
    for b in range(n_bits):
        take = ((offsets >> b) & 1).bool().unsqueeze(-1)
        jumped = torch.remainder(bits @ mats[b].T, 2.0)
        bits = torch.where(take, jumped, bits)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, device=dev)
    return (bits.reshape(offsets.shape + (4, 32)).to(torch.int64)
            * weights).sum(-1)


def randn_block(state, n):
    """Draw ``n`` normals sequentially from ``state`` (int64 (..., 4)).
    Matches reference randn() (src/matlabfunctions.cpp:244-264).
    Returns float64 (..., n)."""
    x, y, z, w = state.unbind(-1)
    draws = []
    for _ in range(n):
        acc = torch.zeros_like(x)
        for _ in range(12):
            t = (x ^ (x << 11)) & _MASK
            x, y, z, w = y, z, w, (w ^ (w >> 19)) ^ (t ^ (t >> 8))
            acc = acc + (w >> 4)
        draws.append(acc.to(torch.float64) / 268435456.0 - 6.0)
    return torch.stack(draws, -1)


def _pack_rows(mats):
    """0/1 matrices (..., 128, 128) with each row packed little-endian
    into 4 words of 32 bits: (..., 128, 4) int32 (csrc/xorshift.cu's
    layout; word k of row i holds M[i, 32k:32k+32])."""
    words = np.packbits(mats, axis=-1, bitorder="little")
    return words.view("<u4").view(np.int32).copy()


@functools.lru_cache(maxsize=None)
def _jump_rows(device):
    """The jump matrices' rows, packed: (_MAX_LOG2, 128, 4) int32 on
    ``device``, uploaded once per device."""
    return torch.as_tensor(_pack_rows(_jump_matrices()), device=device)


@functools.lru_cache(maxsize=None)
def _split_rows(device):
    """The draw split's matrices M_draw^(t * _LANE / _DRAWERS), t = 1 ..
    _DRAWERS - 1 (drawing thread t of a lane starts there), packed:
    (_DRAWERS - 1, 128, 4) int32 on ``device``, uploaded once per
    device."""
    per = _LANE // _DRAWERS
    mats = np.zeros((_DRAWERS - 1, 128, 128), np.uint8)
    for t in range(1, _DRAWERS):
        mats[t - 1] = _draw_jump(per * t)
    return torch.as_tensor(_pack_rows(mats), device=device)


def randn_span_plain(starts, max_start):
    """The plain version: the GF(2) jumps, then the draws' loop."""
    return randn_block(states_at_draws(starts, max_start), _LANE)


def randn_span(starts, max_start):
    """The _LANE draws from each stream position of ``starts`` (int64
    (lanes,)): float64 (lanes, _LANE).  ``max_start`` is the largest
    start, known on the host."""
    if starts.dim() != 1 or starts.dtype != torch.int64:
        raise ValueError(f"starts must be int64 (lanes,), got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    n_bits = max(1, int(max_start).bit_length())
    if n_bits > _MAX_LOG2:
        raise ValueError(f"stream position {max_start} is past "
                         f"2^{_MAX_LOG2}")
    if starts.device.type == "cpu":
        return randn_span_plain(starts, max_start)
    if starts.device.type != "cuda":
        raise ValueError(f"unsupported device {starts.device}")
    starts = starts.contiguous()
    out = torch.empty((starts.shape[0], _LANE), dtype=torch.float64,
                      device=starts.device)
    if starts.numel() == 0:
        return out
    entry = _cuda.entry("xorshift", "randn_span_launch",
                        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p) + (ctypes.c_uint32,) * 4
                        + (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
    _cuda.launch("randn_span", entry, starts.device, starts.data_ptr(),
                 _jump_rows(starts.device).data_ptr(), n_bits,
                 _split_rows(starts.device).data_ptr(), *SEED,
                 out.data_ptr(), starts.shape[0])
    _RANDN_SPAN.launches += 1
    return out


randn_span.launches = 0         # kernel launches (CUDA path only)
# The wrapper itself, whose count a launch raises: randn_blocks_at calls
# the module's name, which a recorder of the calls may stand in for.
_RANDN_SPAN = randn_span


def randn_blocks_at(offsets, n, bounds=None):
    """For each stream position in ``offsets`` (int (...)), the n draws
    starting there: float64 (..., n).

    The span [min, max + n) of the stream is generated once, in lanes of
    _LANE draws that each start from a GF(2) jump (``randn_span``, one
    launch on the card), and every block is a window of that span.
    ``bounds`` = (min, max) of ``offsets``, when the caller has them on
    the host, spares reading them from the device."""
    dev = offsets.device
    flat = offsets.reshape(-1).to(torch.int64)
    lo, hi = bounds if bounds is not None else (int(flat.min()),
                                                int(flat.max()))
    total = hi + n - lo
    n_lanes = -(-total // _LANE)
    starts = lo + torch.arange(n_lanes, device=dev) * _LANE
    seq = randn_span(starts, lo + (n_lanes - 1) * _LANE).reshape(-1)
    idx = (flat - lo).unsqueeze(-1) + torch.arange(n, device=dev)
    return seq[idx].reshape(offsets.shape + (n,))


def randn_sequence(n, device="cpu"):
    """First n draws after a reseed."""
    return randn_blocks_at(torch.zeros(1, dtype=torch.int64,
                                       device=device), n)[0]


def fast_normal(seed, shape, dtype, device):
    """Fast-mode normals from an explicit generator seeded with ``seed``.

    Callers draw one utterance's shape (frames or pulse slots), never the
    batch's, and share it across rows as JAX's vmap shares its draws: a
    row's output is then a function of that row alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def fast_normal_frames(seed, n_frames, tail, dtype, device, frames=None):
    """fast_normal(seed, (n_frames,) + tail), or, with ``frames`` =
    (offset, total), rows offset..offset+n_frames of the whole
    utterance's draw (total,) + tail, zero past its end.  A frame slice
    of an utterance then sees the draws its frames see in the whole
    utterance; slicing is the only way, as a draw of fewer rows is not
    a window of the larger one."""
    if frames is None:
        return fast_normal(seed, (n_frames,) + tail, dtype, device)
    offset, total = frames
    part = fast_normal(seed, (total,) + tail, dtype, device)[
        offset: offset + n_frames]
    if part.shape[0] < n_frames:
        part = torch.cat([part, torch.zeros(
            (n_frames - part.shape[0],) + tail, dtype=dtype,
            device=device)])
    return part
