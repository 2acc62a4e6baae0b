"""Process-wide state the server's threads share: the kernel library's
first build (kernels/build.library) and the float32 matmul precision guard
(core/tensors.full_f32_matmul), each driven by concurrent threads with a
short switch interval. Every join has a timeout.
"""

import sys
import threading
import time

import torch

from qadc_tpu_torch.core import tensors
from qadc_tpu_torch.kernels import build

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

THREADS, ROUNDS, TIMEOUT = 4, 300, 60


def _run(target, n=THREADS):
    """Start n threads on target together; return the errors they raised."""
    start, errors = threading.Barrier(n), []

    def body(i):
        try:
            start.wait(timeout=TIMEOUT)
            target(i)
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    return errors


def test_library_builds_once_under_concurrent_first_calls(monkeypatch, tmp_path):
    builds, loaded = [], object()

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # a compiler run: long enough for every thread to arrive
        return tmp_path / "libqadc_kernels.so", ""

    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build, "_load", lambda path: loaded)
    monkeypatch.setattr(build, "_library", None)
    got = []
    assert _run(lambda i: got.append(build.library())) == []
    assert len(builds) == 1
    assert got == [loaded] * THREADS


def test_full_f32_matmul_holds_across_threads():
    """No thread inside a guard sees the precision another thread restored
    on leaving its own; the setting before the first guard comes back after
    the last."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        def body(i):
            for k in range(ROUNDS):
                with tensors.full_f32_matmul():
                    if (k + i) % 3 == 0:
                        with tensors.full_f32_matmul():  # nested in one thread
                            time.sleep(0)
                    time.sleep(0)
                    got = torch.get_float32_matmul_precision()
                    if got != "highest":
                        raise AssertionError(f"round {k}: {got} inside the guard")

        assert _run(body) == []
        assert torch.get_float32_matmul_precision() == "high"
        assert tensors._precision_depth == 0
    finally:
        torch.set_float32_matmul_precision(before)
