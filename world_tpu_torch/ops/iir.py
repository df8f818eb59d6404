"""Per-sample and per-block IIR recurrences: csrc/iir.cu and their plain
versions.

``iir_zero_phase(x (..., n) float64, recurrence, r=None)``
    flip(f(flip(f(x)))) along the last axis: forward-backward filtering
    from a zero state, f being
    "decimate": decimate's 3rd-order direct-form-II stage of ratio ``r``
    (2..12; ops/matlab.py: _filter_for_decimate), or
    "smooth": Harvest's smoothing biquad (models/harvest_contour.py:
    _biquad),
    each in the reference's order of operations.
``lti_state_scan(p (..., nblk, S), AL (S, S))``
    The carried state of the block-LTI form (ops/matlab.py:
    lti_block_filter): states[..., j, :] is the state before block j,
    from s = 0 and s = AL s + p[..., j, :], each row of AL s + p summed
    left to right.  float32 or float64, 1 <= S <= 4.

The JAX package runs these as device loops (lax.scan in
world_tpu/ops/matlab.py:184 and :226 and
world_tpu/models/harvest_contour.py:365); the plain versions are the
port's Python loops over samples and blocks, which launch kernels at
every step.  Each kernel walks a whole lane's chain in one thread while
other threads move its data, all lanes in one launch; csrc/iir.cu
describes the designs.

On a CUDA tensor each wrapper launches its kernel (always; there is no
fallback): a build or launch failure raises.  On a CPU tensor it runs the
plain version.  The kernels equal the plain versions bit for bit.
"""

import ctypes

import torch

from . import _cuda

RECURRENCES = ("decimate", "smooth")
MAX_STATE = 4


def _on_card(t, dtypes, what):
    """Checks common to the wrappers; True for a CUDA tensor (the kernel),
    False for a CPU one (the plain version)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{what} must be one of {dtypes}, got {t.dtype}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return True


def _recurrence(recurrence, r):
    """(the plain one-pass filter, the kernel's kind and five
    coefficients) of ``recurrence``."""
    from ..models import harvest_contour
    from . import matlab

    if recurrence == "decimate":
        if r not in range(2, 13):
            raise ValueError(f"decimate's ratio must be 2..12, got {r}")
        return ((lambda t: matlab._filter_for_decimate(t, r)), 0,
                [float(v) for v in matlab._DECIMATE_COEFFS[r]])
    if recurrence == "smooth":
        b0, b1 = harvest_contour._B
        a0, a1 = harvest_contour._A
        return harvest_contour._biquad, 1, [b0, b1, a0, a1, 0.0]
    raise ValueError(f"recurrence must be one of {RECURRENCES}, got "
                     f"{recurrence!r}")


def iir_zero_phase_plain(x, recurrence, r=None):
    """The plain version: the per-sample loop forward, flipped, again,
    flipped back."""
    f = _recurrence(recurrence, r)[0]
    return f(f(x).flip(-1)).flip(-1)


def iir_zero_phase(x, recurrence, r=None):
    """Zero-phase ``recurrence`` of the float64 tensor ``x`` along its
    last axis.  Returns a tensor of x's shape."""
    on_card = _on_card(x, (torch.float64,), "x")
    if x.dim() == 0:
        raise ValueError("x must have a last axis")
    _, kind, coeffs = _recurrence(recurrence, r)
    if not on_card:
        return iir_zero_phase_plain(x, recurrence, r)
    out = torch.empty_like(x)
    n = x.shape[-1]
    if x.numel() == 0:
        return out
    entry = _cuda.entry("iir", "iir_zero_phase_launch",
                        (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_longlong)
                        + (ctypes.c_double,) * 5 + (ctypes.c_void_p,))
    _cuda.launch("iir_zero_phase", entry, x.device, kind, x.data_ptr(),
                 out.data_ptr(), x.numel() // n, n, *coeffs)
    iir_zero_phase.launches += 1
    return out


iir_zero_phase.launches = 0     # kernel launches (CUDA path only)


def lti_state_scan_plain(p, AL):
    """The plain version: a loop over blocks, ``s @ AL.T`` written out as
    products and sums in index order."""
    S = AL.shape[0]
    s = torch.zeros(p.shape[:-2] + (S,), dtype=p.dtype, device=p.device)
    states = []
    for j in range(p.shape[-2]):
        states.append(s)                    # pre-block state
        rows = []
        for i in range(S):
            acc = s[..., 0] * AL[i, 0]
            for k in range(1, S):
                acc = acc + s[..., k] * AL[i, k]
            rows.append(acc + p[..., j, i])
        s = torch.stack(rows, -1)
    if not states:
        return torch.empty_like(p)
    return torch.stack(states, -2)


def lti_state_scan(p, AL):
    """The pre-block states (..., nblk, S) of the block recurrence with
    per-block inputs ``p`` (..., nblk, S) and block transition ``AL``
    (S, S), p's dtype and device."""
    on_card = _on_card(p, (torch.float32, torch.float64), "p")
    S = AL.shape[0] if AL.dim() == 2 else -1
    if p.dim() < 2 or AL.shape != (S, S) or p.shape[-1] != S \
            or not 1 <= S <= MAX_STATE:
        raise ValueError(f"shapes: p {tuple(p.shape)}, AL "
                         f"{tuple(AL.shape)} (want (..., nblk, S) and "
                         f"(S, S), S <= {MAX_STATE})")
    if AL.dtype != p.dtype or AL.device != p.device:
        raise ValueError(f"AL ({AL.dtype}, {AL.device}) must match p "
                         f"({p.dtype}, {p.device})")
    if not on_card:
        return lti_state_scan_plain(p, AL)
    AL = AL.contiguous()
    out = torch.empty_like(p)
    if p.numel() == 0:
        return out
    nblk = p.shape[-2]
    entry = _cuda.entry("iir", "lti_state_scan_launch",
                        (ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 3
                        + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    _cuda.launch("lti_state_scan", entry, p.device, p.element_size(), S,
                 p.data_ptr(), AL.data_ptr(), out.data_ptr(),
                 p.numel() // (nblk * S), nblk)
    lti_state_scan.launches += 1
    return out


lti_state_scan.launches = 0     # kernel launches (CUDA path only)
