"""The control: the reference computed one precision lower (int4 tables;
TF32 products, which only a card has) put in the program's place, on the
same sampled answers, is not correct at a size a test run holds."""

import pytest
import torch

import tiny
from portbench import check

torch.set_num_threads(2)


@pytest.mark.parametrize("cell", ["ivf-b", "flat-b"])
def test_the_control_fails_a_limit(tiny_root, cell):
    keep = {}
    result, checks = tiny.run(tiny_root, cell, keep=keep)
    assert result["correct"] is True, checks
    numbers = check.judge(keep["dep"], keep["got"], control=True)
    ok, shown = check.verdict(numbers, keep["dep"].cfg["limits"])
    assert not ok, shown
    assert numbers["miss"] > 3 * max(checks["miss"]["value"], 0.01)
