"""The benchmark's CPU tests: run with `python -m pytest portbench/tests`.

Tests that need a CUDA card take the `cuda` fixture, which skips them on a
machine without one."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import tiny

    return tiny.make_root(tmp_path_factory.mktemp("tiny"))
