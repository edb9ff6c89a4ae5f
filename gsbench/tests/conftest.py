"""Settings of the benchmark's own tests (run: python -m pytest gsbench/tests -q).

The repository's ``tests/conftest.py`` imports JAX, which nothing of the
benchmark may load, so these tests register their own ``cuda`` marker: a
test that needs the card carries it and decides inside itself whether to
skip.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's tests run on the machine with the GPU")
    return torch.device("cuda:0")
