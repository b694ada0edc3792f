"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository root.  They run on the CPU; the tests marked ``card`` need an
NVIDIA card and skip without one (decided inside the ``card`` fixture)."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the cell's kernels on the card")
    return "cuda"
