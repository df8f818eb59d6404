"""The benchmark's own tests, on the CPU:

    python -m pytest -p no:cacheprovider portbench/tests

Tests that need the card take the ``cuda`` fixture and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
