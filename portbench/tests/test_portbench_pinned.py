"""The judged numbers of the 4-bit Quick ADC cells stay where they were.

check.judge's four numbers, and the control's, on the tiny IVF and flat
cells (tiny.py), each deployment built from one seed and every query of
its pool answered by the closed loop's engine, against the readings taken
before the harness learned 8-bit conventional ADC configurations. Two
torch threads, as the readings were taken: the training's float sums
follow the thread count.

    python -m pytest portbench/tests/test_portbench_pinned.py
"""

import numpy as np
import pytest
import torch

import tiny
from portbench import check, deploy

torch.set_num_threads(2)

SEED = 2 ** 32 + 77
PINNED = {
    "tiny-ivf": {
        "program": {"miss": 0.0, "dist_err": 0.0, "code_mismatch": 0.0,
                    "train_excess": 0.011044577539625733},
        "control": {"miss": 0.949999988079071, "dist_err": 0.0, "code_mismatch": 0.0,
                    "train_excess": 0.0}},
    "tiny-flat": {
        "program": {"miss": 0.0, "dist_err": 4.4277763322497776e-07, "code_mismatch": 0.0,
                    "train_excess": 0.010533811445851526},
        "control": {"miss": 1.7999999523162842, "dist_err": 0.0, "code_mismatch": 0.0,
                    "train_excess": 0.0}},
}


@pytest.mark.parametrize("cfg", [tiny.IVF, tiny.FLAT], ids=lambda c: c["name"])
def test_the_4bit_judged_numbers_are_unchanged(cfg):
    from qadc_tpu_torch.engine import QueryEngine

    dep = deploy.build(cfg, SEED, torch.device("cpu"))
    engine = QueryEngine(dep.index, r=cfg["r"], ma=cfg.get("ma", 1), keep=cfg["keep"],
                         adc_type="qadc", batch_size=tiny.CLOSED["batch"], rerank=cfg["rerank"])
    d, lab, _ = engine.run(dep.pool_np)
    got = check.sample(np.arange(len(d)), lab, d, deploy.subseed(SEED, "sample"))
    read = {"program": check.judge(dep, got), "control": check.judge(dep, got, control=True)}
    assert read == PINNED[cfg["name"]]
