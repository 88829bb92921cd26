"""Tests of the benchmark's harness, on the CPU.  A test that needs a CUDA
card carries the ``cuda`` marker and skips without one."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    """Each test writes its scenes under a temporary directory of its own, so
    that tests run side by side never share ``$TMPDIR/benchmark/<cell>``."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
