"""MATLAB-compatible numeric primitives (reference
src/matlabfunctions.cpp), on tensors with any leading batch dims.

Edge-case behaviour (histc boundary handling, interp1Q truncation,
decimate's reflected edges) matches the reference; the golden checks of
tests/test_primitives.py hold the port too (tests/test_torch_primitives.py).
"""

import functools

import numpy as np
import torch

from ..device import div
from .iir import iir_zero_phase, lti_state_scan


def matlab_round(x):
    """Round half away from zero (src/matlabfunctions.cpp:206-208).
    Returns int64.  Kept as separate eager ops: a fused multiply-add of
    an upstream product with the +0.5 would flip frame positions that
    land exactly on .5 samples, so never compile this."""
    half = torch.where(x > 0, 0.5, -0.5).to(x.dtype)
    return torch.trunc(x + half).to(torch.int64)


def fftshift(x):
    """Swap halves (src/matlabfunctions.cpp:129-134); even length only."""
    n = x.shape[-1]
    return torch.cat([x[..., n // 2:], x[..., : n // 2]], dim=-1)


def take_last(a, idx):
    """``a[..., idx]`` with ``a``'s leading dims broadcast against
    ``idx``'s (a batched gather along the last axis)."""
    lead = torch.broadcast_shapes(a.shape[:-1], idx.shape[:-1])
    return torch.gather(a.expand(lead + a.shape[-1:]), -1,
                        idx.expand(lead + idx.shape[-1:]))


def interp1(x, y, xi, n_valid=None):
    """Linear interpolation with MATLAB histc semantics
    (src/matlabfunctions.cpp:136-176).

    ``x`` ascending along its last axis, and so are the queries ``xi``.
    Queries outside the grid extrapolate with the first/last segment.
    ``n_valid`` (tensor over the leading dims) marks how many leading
    entries of ``x``/``y`` are real; padding entries of ``x`` must be
    +inf.  Leading dims of x, y, xi (and n_valid) broadcast.
    """
    lead = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1], xi.shape[:-1])
    n = x.shape[-1]
    xb = x.expand(lead + (n,)).contiguous()
    q = xi.expand(lead + xi.shape[-1:]).contiguous()
    k = torch.searchsorted(xb, q, right=True)
    if n_valid is None:
        hi = n - 1
        k = k.clamp(1, hi)
    else:
        hi = (n_valid - 1).unsqueeze(-1)
        k = torch.minimum(k.clamp(min=1), hi)
    # n_valid < 2 leaves no segment; callers mask those rows, but the
    # gather indices must stay in range (torch raises where JAX clamps).
    k = k.clamp(1, n - 1)
    x0 = torch.gather(xb, -1, k - 1)
    x1 = torch.gather(xb, -1, k)
    y0 = take_last(y, k - 1)
    y1 = take_last(y, k)
    s = (q - x0) / (x1 - x0)
    return y0 + s * (y1 - y0)


def interp1q(x0, shift, y, xi):
    """Uniform-grid linear interpolation (src/matlabfunctions.cpp:214-235).

    ``x0`` is the coordinate of y[..., 0]; ``shift`` the grid step (may
    be negative).  The index is computed by C truncation toward zero, and
    the last valid sample extrapolates flat (delta_y[n-1] = 0).
    """
    n_y = y.shape[-1]
    num = xi - x0
    t = num / shift if isinstance(shift, torch.Tensor) else div(num, shift)
    base = torch.trunc(t).to(torch.int64)
    frac = t - base.to(t.dtype)
    base_c = base.clamp(0, n_y - 1)
    y0 = take_last(y, base_c)
    y1 = take_last(y, (base_c + 1).clamp(0, n_y - 1))
    delta = torch.where(base_c >= n_y - 1, torch.zeros_like(y0), y1 - y0)
    return y0 + delta * frac


# Zero-phase decimation filter coefficients, one biquad-cascade per ratio
# (reference: src/matlabfunctions.cpp:27-113).  Row r: a0 a1 a2 b0 b1.
_DECIMATE_COEFFS = np.zeros((13, 5))
_DECIMATE_COEFFS[2] = (0.041156734567757189, -0.42599112459189636,
                       0.041037215479961225, 0.16797464681802227,
                       0.50392394045406674)
_DECIMATE_COEFFS[3] = (0.95039378983237421, -0.67429146741526791,
                       0.15412211621346475, 0.071221945171178636,
                       0.21366583551353591)
_DECIMATE_COEFFS[4] = (1.4499664446880227, -0.98943497080950582,
                       0.24578252340690215, 0.036710750339322612,
                       0.11013225101796784)
_DECIMATE_COEFFS[5] = (1.7610939654280557, -1.2554914843859768,
                       0.3237186507788215, 0.021334858522387423,
                       0.06400457556716227)
_DECIMATE_COEFFS[6] = (1.9715352749512141, -1.4686795689225347,
                       0.3893908434965701, 0.013469181309343825,
                       0.040407543928031475)
_DECIMATE_COEFFS[7] = (2.1225239019534703, -1.6395144861046302,
                       0.44469707800587366, 0.0090366882681608418,
                       0.027110064804482525)
_DECIMATE_COEFFS[8] = (2.2357462340187593, -1.7780899984041358,
                       0.49152555365968692, 0.0063522763407111993,
                       0.019056829022133598)
_DECIMATE_COEFFS[9] = (2.3236003491759578, -1.8921545617463598,
                       0.53148928133729068, 0.0046331164041389372,
                       0.013899349212416812)
_DECIMATE_COEFFS[10] = (2.3936475118069387, -1.9873904075111861,
                        0.5658879979027055, 0.0034818622251927556,
                        0.010445586675578267)
_DECIMATE_COEFFS[11] = (2.450743295230728, -2.06794904601978,
                        0.59574774438332101, 0.0026822508007163792,
                        0.0080467524021491377)
_DECIMATE_COEFFS[12] = (2.4981398605924205, -2.1368928194784025,
                        0.62187513816221485, 0.0021097275904709001,
                        0.0063291827714127002)


def lti_block_tables(M, e, c, d, block):
    """Block-form tables for the causal LTI recurrence
        s_t = M s_{t-1} + e x_t,   y_t = d x_t + c . s_{t-1}
    (zero initial state).  Over a block of ``block`` samples
        y = X K^T + S R^T,   s' = M^block s + P X
    with K lower-triangular Toeplitz (K[j,j] = d, K[j,i] = c M^{j-1-i} e
    below), R[j] = c M^j, P[:,i] = M^{block-1-i} e.  Built in float64
    on the host (cast at use)."""
    M = np.asarray(M, np.float64)
    e = np.asarray(e, np.float64)
    c = np.asarray(c, np.float64)
    powers = [np.eye(M.shape[0])]
    for _ in range(block):
        powers.append(powers[-1] @ M)
    k = np.array([c @ p @ e for p in powers])
    K = np.zeros((block, block))
    for j in range(block):
        K[j, j] = d
        if j:
            K[j, :j] = k[j - 1 :: -1]
    R = np.stack([c @ powers[j] for j in range(block)])
    P = np.stack([powers[block - 1 - i] @ e for i in range(block)], axis=1)
    return K, R, P, powers[block]


# lti_block_filter's tables as tensors: (id(tables), dtype, device) ->
# (tables, (K^T, R^T, P^T, AL)); the tables object is kept so that its id
# is not reused.
_TABLES_ON = {}


def _tables_on(tables, dtype, device):
    """``tables`` as tensors of ``dtype`` on ``device``, uploaded once:
    the transposes the products take (views, as ``.T`` at the call would
    give) and AL."""
    key = (id(tables), dtype, device)
    hit = _TABLES_ON.get(key)
    if hit is None or hit[0] is not tables:
        K, R, P, AL = (torch.as_tensor(t, dtype=dtype, device=device)
                       for t in tables)
        hit = _TABLES_ON[key] = (tables, (K.T, R.T, P.T, AL))
    return hit[1]


def lti_block_filter(x, tables):
    """Apply the block-form LTI filter along the LAST axis of ``x`` (any
    leading lane dims; zero initial state): three dense products plus a
    per-block state recurrence of n/block steps (ops/iir.py:
    lti_state_scan, one kernel launch on the card).  TF32 is switched off
    so the float32 products stay float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    KT, RT, PT, AL = _tables_on(tables, x.dtype, x.device)
    lead = x.shape[:-1]
    n = x.shape[-1]
    block = KT.shape[0]
    nblk = -(-n // block)
    xb = torch.nn.functional.pad(x, (0, nblk * block - n)).reshape(
        lead + (nblk, block))
    y0 = xb @ KT                            # (..., nblk, block)
    p = xb @ PT                             # (..., nblk, state)
    y = y0 + lti_state_scan(p, AL) @ RT
    return y.reshape(lead + (nblk * block,))[..., :n]


@functools.lru_cache(maxsize=None)
def _decimate_block_tables(r, block):
    """lti_block_tables for decimate's 3rd-order direct-form-II stage:
    s_t = (w_t, w_{t-1}, w_{t-2})."""
    a = _DECIMATE_COEFFS[r, :3]
    b0, b1 = _DECIMATE_COEFFS[r, 3:]
    A = np.zeros((3, 3))
    A[0] = a
    A[1, 0] = 1.0
    A[2, 1] = 1.0
    c = b0 * a + np.array([b1, b1, b0])
    return lti_block_tables(A, np.array([1.0, 0.0, 0.0]), c, b0, block)


def _filter_for_decimate(x, r):
    """3rd-order IIR (direct form II) used by decimate
    (src/matlabfunctions.cpp:27-125), along the last axis.

    float64: the per-sample recurrence in the reference's order (the
    golden path, and the plain version of ops/iir.py's iir_zero_phase,
    which decimate calls).  float32: the block-LTI form, which differs
    from the recurrence only in rounding (~1e-6 relative, far inside the
    0.1-cent F0 gate)."""
    if x.dtype != torch.float64:
        return lti_block_filter(x, _decimate_block_tables(r, 128))
    # The same recurrence, w_t = x_t + a0 w_{t-1} + a1 w_{t-2} + a2 w_{t-3}
    # and y_t = b0 w_t + b1 w_{t-1} + b1 w_{t-2} + b0 w_{t-3}, as scipy's
    # direct-form filter on the host (the per-sample loop is too slow for
    # corpus-length rows).
    from scipy.signal import lfilter
    a0, a1, a2, b0, b1 = (float(v) for v in _DECIMATE_COEFFS[r])
    y = lfilter([b0, b1, b1, b0], [1.0, -a0, -a1, -a2],
                x.detach().cpu().numpy(), axis=-1)
    return torch.as_tensor(y, dtype=x.dtype, device=x.device)


def decimate(x, r):
    """r-fold decimation with zero-phase IIR low-pass along the last axis
    (src/matlabfunctions.cpp:178-204): 9-sample reflected edges,
    forward-backward filtering, then strided pick.
    Output length is (len-1)//r + 1.
    """
    n = x.shape[-1]
    k = 9  # kNFact
    head = 2.0 * x[..., :1] - x[..., 1:k + 1].flip(-1)
    tail = 2.0 * x[..., n - 1:n] - x[..., n - 1 - k:n - 1].flip(-1)
    t = torch.cat([head, x, tail], dim=-1)
    if t.dtype == torch.float64:
        t = iir_zero_phase(t, "decimate", r)    # one launch on the card
    else:
        t = _filter_for_decimate(t, r).flip(-1)
        t = _filter_for_decimate(t, r).flip(-1)
    nout = (n - 1) // r + 1
    nbeg = r - r * nout + n
    # y[c] = t[nbeg + c*r + kNFact - 1]  (src/matlabfunctions.cpp:195-200)
    start = nbeg + k - 1
    return t[..., start:start + (nout - 1) * r + 1:r]


def fast_fftfilt(x, h, fft_size):
    """FFT-domain filtering (src/matlabfunctions.cpp:266-301): both inputs
    divided by fft_size before the forward transforms, unnormalized c2r
    backward.  Returns (..., fft_size)."""
    spec = (torch.fft.rfft(x, n=fft_size) / fft_size
            * (torch.fft.rfft(h, n=fft_size) / fft_size))
    return torch.fft.irfft(spec, n=fft_size) * fft_size


def matlab_std(x):
    """Sample standard deviation along the last axis
    (src/matlabfunctions.cpp:303-313)."""
    m = x.mean(-1, keepdim=True)
    return torch.sqrt(div(((x - m) ** 2).sum(-1), x.shape[-1] - 1))
