"""Runs of the harness with the timed path broken underneath, or the
program's training: each fault a search cell can have makes `correct` come
out false. The chip check is skipped (the tiny cells run on the CPU, on the
kernels' plain versions); the rest of a run is the benchmark's own."""

import numpy as np
import pytest
import torch

import tiny
from portbench import faults

torch.set_num_threads(2)


def _wrap(monkeypatch, alter):
    """Break both index searches underneath the engine."""
    from qadc_tpu_torch.index import flat, ivf

    def fault(ctx):
        for mod in (ivf, flat):
            real = mod.search_qadc

            def broken(*args, _real=real, **kw):
                return alter(*_real(*args, **kw))

            monkeypatch.setattr(mod, "search_qadc", broken)
    return fault


def answer_altered(d, lab):
    """One query's answer altered where it is produced: other labels."""
    lab = lab.clone()
    lab[0] = (lab[0] + 1) % 6000
    return d, lab


def half_left_out(d, lab):
    """Half of the batch not searched: every second query gets its
    neighbour's answer."""
    idx = torch.arange(lab.shape[0]) // 2 * 2
    return d[idx], lab[idx]


class Stale:
    """A step that returns its state unchanged: the previous batch's answers."""

    def __init__(self):
        self.last = None

    def __call__(self, d, lab):
        prev, self.last = self.last, (d, lab)
        if prev is None or prev[1].shape != lab.shape:
            return d, lab
        return prev


FAULTS = {"answer_altered": lambda: answer_altered, "half_left_out": lambda: half_left_out,
          "state_unchanged": Stale}


@pytest.mark.parametrize("cell", ["ivf-b", "flat-b"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    result, checks = tiny.run(tiny_root, cell, seconds=0.5,
                              fault=_wrap(monkeypatch, FAULTS[fault]()))
    assert result["correct"] is False, checks
    assert any(v["value"] > v["limit"] for v in checks.values())


@pytest.mark.parametrize("cell", ["ivf-b", "flat-b"])
def test_the_unbroken_path_is_correct(tiny_root, cell):
    result, checks = tiny.run(tiny_root, cell, seconds=0.5)
    assert result["correct"] is True, checks
    assert np.isfinite([v["value"] for v in checks.values()]).all()


@pytest.mark.parametrize("cell,fault", [("ivf-b", "codebooks_at_seeds"),
                                        ("flat-b", "codebooks_at_seeds"),
                                        ("flat-b", "rotation_identity")])
def test_a_broken_training_is_not_correct(tiny_root, cell, fault):
    """The search checks follow the program's trained state, so they pass
    a badly trained quantizer; train_excess, against the reference's own
    training, does not."""
    with faults.planted(fault):
        result, checks = tiny.run(tiny_root, cell, seconds=0.3)
    assert result["correct"] is False, checks
    assert checks["train_excess"]["value"] > checks["train_excess"]["limit"]
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("miss", "dist_err", "code_mismatch")), checks


def test_a_planted_fault_is_taken_out_again():
    from qadc_tpu_torch.index import ivf
    from qadc_tpu_torch.quantizers import opq

    before = (opq.train_opq, ivf.train_coarse)
    for name in faults.NAMES:
        with faults.planted(name):
            assert (opq.train_opq, ivf.train_coarse) != before
        assert (opq.train_opq, ivf.train_coarse) == before
