"""Port codec (world_tpu_torch.models.codec) against the C++ goldens and
the JAX package.

Tolerances: float64 meets tests/test_codec.py's golden gates (coded ap
atol 1e-9, decoded ap atol 1e-10, coded sp atol 1e-9, decoded sp rtol
1e-9); float32 matches JAX's float32 codec at rtol/atol 1e-5 (float32
rounding of log/exp and the FFT); a (B, F, K) batch equals per-row calls
exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from world_tpu.models import codec as jax_codec  # noqa: E402
from world_tpu_torch.models import codec  # noqa: E402


def test_code_aperiodicity(gold):
    out = codec.code_aperiodicity(gold["d4c_ap"], gold.scalar("fs"),
                                  gold.scalar("fft_size"), device="cpu")
    np.testing.assert_allclose(out.numpy(), gold["coded_ap"], atol=1e-9)


def test_decode_aperiodicity(gold):
    out = codec.decode_aperiodicity(gold["coded_ap"], gold.scalar("fs"),
                                    gold.scalar("fft_size"), device="cpu")
    np.testing.assert_allclose(out.numpy(), gold["decoded_ap"], atol=1e-10)


def test_code_spectral_envelope(gold):
    out = codec.code_spectral_envelope(
        gold["cheaptrick_sp"], gold.scalar("fs"), gold.scalar("sp_dim"),
        gold.scalar("fft_size"), device="cpu").numpy()
    assert out.shape == gold["coded_sp"].shape
    np.testing.assert_allclose(out, gold["coded_sp"], atol=1e-9)


def test_decode_spectral_envelope(gold):
    out = codec.decode_spectral_envelope(
        gold["coded_sp"], gold.scalar("fs"), gold.scalar("fft_size"),
        device="cpu").numpy()
    np.testing.assert_allclose(out, gold["decoded_sp"], rtol=1e-9)


def test_number_of_aperiodicities(gold):
    assert codec.get_number_of_aperiodicities(gold.scalar("fs")) == \
        gold.scalar("n_aper")


@pytest.mark.parametrize("fs,fft_size", [(22050, 1024), (48000, 2048),
                                         (8000, 512)])
def test_f32_matches_jax_f32(gold, fs, fft_size):
    rs = np.random.RandomState(fs)
    K = fft_size // 2 + 1
    sp = np.exp(rs.randn(20, K) * 0.5).astype(np.float32)
    ap = np.clip(np.abs(rs.randn(20, K)) * 0.3, 1e-3,
                 0.999).astype(np.float32)
    pairs = [
        (codec.code_spectral_envelope(sp, fs, 40, fft_size, device="cpu"),
         jax_codec.code_spectral_envelope(sp, fs, 40, fft_size)),
        (codec.code_aperiodicity(ap, fs, fft_size, device="cpu"),
         jax_codec.code_aperiodicity(ap, fs, fft_size))]
    # JAX promotes parts of the envelope coding to float64: decode
    # float32 coefficients in both.
    csp, cap = (np.asarray(w, np.float32) for _, w in pairs)
    pairs += [
        (codec.decode_spectral_envelope(csp, fs, fft_size, device="cpu"),
         jax_codec.decode_spectral_envelope(csp, fs, fft_size)),
        (codec.decode_aperiodicity(cap, fs, fft_size, device="cpu"),
         jax_codec.decode_aperiodicity(cap, fs, fft_size))]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_batches_equal_per_row_calls(gold):
    """(B, F, K) through the *_batch functions == each row alone."""
    fs, fft = gold.scalar("fs"), gold.scalar("fft_size")
    sp = torch.as_tensor(np.stack([gold["cheaptrick_sp"],
                                   gold["cheaptrick_sp"][::-1] * 0.5]))
    ap = torch.as_tensor(np.stack([gold["d4c_ap"],
                                   gold["d4c_ap"][::-1] ** 2]))
    csp = codec.code_spectral_envelope_batch(sp, fs, fft, 48)
    cap = codec.code_aperiodicity_batch(ap, fs, fft)
    dsp = codec.decode_spectral_envelope_batch(csp, fs, fft)
    dap = codec.decode_aperiodicity_batch(cap, fs, fft)
    for b in range(2):
        for got, want in (
                (csp[b], codec.code_spectral_envelope(sp[b], fs, 48, fft,
                                                      device="cpu")),
                (cap[b], codec.code_aperiodicity(ap[b], fs, fft,
                                                 device="cpu")),
                (dsp[b], codec.decode_spectral_envelope(csp[b], fs, fft,
                                                        device="cpu")),
                (dap[b], codec.decode_aperiodicity(cap[b], fs, fft,
                                                   device="cpu"))):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
