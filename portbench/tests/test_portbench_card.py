"""The same checks on the card (skipped without one): the device
generators repeat there, a tiny cell runs correct on the CUDA kernels, and
the control (TF32 products, int4 tables) fails a limit there.

    python -m pytest portbench/tests/test_portbench_card.py   # on a card
"""

import time

import torch

from portbench import check, harness
from portbench.data import gist_moment, sift_moment


def test_generators_repeat_on_the_card(cuda):
    for gen in (sift_moment, gist_moment):
        a = gen.draw(torch.Generator(device=cuda).manual_seed(2 ** 32 + 3), [500], clusters=8)
        b = gen.draw(torch.Generator(device=cuda).manual_seed(2 ** 32 + 3), [500], clusters=8)
        assert torch.equal(a[0], b[0]) and a[0].is_cuda


def test_a_tiny_cell_and_its_control_on_the_card(cuda, tiny_root):
    for name in ("ivf-b", "flat-b"):
        keep = {}
        cell = harness.find_cell(name, tiny_root)
        result, checks = harness.run_cell(cell, 2 ** 31 + 9, 0.5, False, cuda,
                                          time.perf_counter(), keep=keep)
        assert result["correct"] is True, checks
        assert result["device"]["platform"] == "gpu"
        numbers = check.judge(keep["dep"], keep["got"], control=True)
        ok, shown = check.verdict(numbers, keep["dep"].cfg["limits"])
        assert not ok, shown
