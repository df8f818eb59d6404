"""Tests of the port that need a CUDA card: the OLA kernel against its
plain version, IEEE division by fs on the card, and the batched step
through the kernel.  Each skips without a card.

This file imports neither jax nor the JAX package and reads the goldens
itself, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from world_tpu_torch.device import div  # noqa: E402
from world_tpu_torch.ops.ola import ola_accumulate, ola_plain  # noqa: E402
from world_tpu_torch.parallel import pipeline  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def golden(name):
    shapes = {}
    with open(os.path.join(GOLDENS, "manifest.txt")) as f:
        for line in f:
            parts = line.split()
            if parts[0] != "scalar":
                shapes[parts[0]] = tuple(int(p) for p in parts[1:])
    return np.fromfile(os.path.join(GOLDENS, name + ".f64")).reshape(
        shapes[name])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ola_kernel_matches_plain(cuda, dtype):
    """The kernel == its plain version (atol 0) at the main path's
    nominal shapes and with unsorted offsets; the counter counts."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for B, P, fft, yp in ((16, 1249, 1024, 19468), (16, 1114, 2048, 37697),
                          (3, 77, 512, 5000)):
        r = torch.randn((B, P, fft), generator=gen, dtype=dt, device=cuda)
        o = torch.randint(0, yp - fft + 1, (B, P), generator=gen,
                          dtype=torch.int32, device=cuda)
        before = ola_accumulate.launches
        got = ola_accumulate(r, o, y_padded=yp)
        assert ola_accumulate.launches == before + 1
        assert got.dtype == dt
        assert torch.equal(got, ola_plain(r, o, yp))


def test_div_on_card_matches_cpu(cuda):
    """On the card, division by a Python scalar is a reciprocal multiply;
    device.div must still give the CPU's IEEE quotients."""
    a = torch.arange(40000, dtype=torch.float32)
    np.testing.assert_array_equal(div(a.to(cuda), 1000.0).cpu().numpy(),
                                  (a / 1000.0).numpy())


def test_batch_step_on_card(cuda):
    """The float32 fast step on the card at batch 2 meets the golden F0
    and envelope gates and goes through the OLA kernel once."""
    x = golden("x").astype(np.float32)
    ref = golden("harvest_f0")
    step = pipeline.make_batch_step(22050, len(x), rng_mode="fast",
                                    device=cuda)
    before = ola_accumulate.launches
    f0, sp, _, _ = step(np.stack([x, 0.7 * x]))
    assert ola_accumulate.launches == before + 1
    f0 = f0[0].double().cpu().numpy()
    assert ((f0 > 0) == (ref > 0)).mean() > 0.99
    v = (f0 > 0) & (ref > 0)
    assert np.sqrt(np.mean((1200 * np.log2(f0[v] / ref[v])) ** 2)) < 0.1
    err_db = np.abs(10 * np.log10(sp[0].double().cpu().numpy()
                                  / golden("cheaptrick_sp")))
    assert np.median(err_db) < 0.01
