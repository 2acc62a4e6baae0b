"""The benchmark's own CPU tests (portbench/tests), one case a file.

Each file runs in a pytest of its own, in a subprocess: the benchmark's
harness refuses a process in which JAX is loaded, and this suite's workers
load it (tests/conftest.py). A file passes when its pytest exits 0; the card
tests in it skip here.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_threads import ONE_THREAD_ENV

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "portbench" / "tests").glob("test_*.py"))
TIMEOUT = 300


@pytest.mark.parametrize("path", FILES, ids=[p.stem for p in FILES])
def test_portbench_file_passes(path):
    out = subprocess.run(
        [sys.executable, "-m", "pytest", str(path), "-q", "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT,
        env={**os.environ, "PYTHONPATH": str(REPO), **ONE_THREAD_ENV})
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
