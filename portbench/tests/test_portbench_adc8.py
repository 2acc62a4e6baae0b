"""An IVF configuration of 8-bit conventional ADC (`adc_type` "adc", OPQ
8x8) at a tiny size on the CPU, through the harness as a benchmark run
makes it.

The closed loop's QueryEngine runs the port's grouped adc8 search (the
`search` span's path `ivf.adc8`: part_pad is a multiple of 512) on the
kernels' plain versions, and check.py judges it against the reference's
8-bit search (reference/search.py: bfloat16 window minima, a screen of
r + max(16, r // 8) windows, a float32 rerank): the run is correct; the
control (TF32 products, the rerank summed from the bfloat16 tables), a
broken timed path and a planted training fault are not. The reference's
answers equal the port's `ivf.search_adc` on the same index, and the
reference decodes the 8-bit codes the port stores.

    python -m pytest portbench/tests/test_portbench_adc8.py
"""

import json

import pytest
import torch

import tiny
from portbench import check, faults
from portbench.reference import search as reference
from test_portbench_faults import FAULTS

torch.set_num_threads(2)

ADC8 = {k: v for k, v in tiny.IVF.items() if k not in ("keep", "rerank", "screen_windows")}
ADC8.update(name="tiny-ivf8", sq_count=8, sq_bits=8, adc_type="adc")
CELL = "ivf8-b"
SEED = 2 ** 32 + 23


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    spec = tiny.spec()
    spec["configs"].append({"name": ADC8["name"], "source": "test", "why": "test",
                            "file": f"portbench/configs/{ADC8['name']}.json", "reduced": []})
    spec["workloads"].append({"name": CELL, "config": ADC8["name"], "traffic": "closed",
                              "chips": 1, "why": "test"})
    root = tiny.make_root(tmp_path_factory.mktemp("adc8"), spec)
    (root / "portbench" / "configs" / f"{ADC8['name']}.json").write_text(json.dumps(ADC8))
    return root


@pytest.fixture(scope="module")
def ran(root):
    from qadc_tpu_torch.eval.trace import recording

    keep = {}
    with recording() as rec:
        result, checks = tiny.run(root, CELL, seed=SEED, keep=keep)
    paths = {s.attrs.get("path") for s in rec.spans if s.name == "search"}
    return result, checks, keep, paths


def test_the_grouped_adc8_path_runs_and_is_correct(ran):
    result, checks, keep, paths = ran
    assert result["correct"] is True, checks
    assert paths == {"ivf.adc8"}
    index = keep["dep"].index
    assert (index.pq.sq_count, index.pq.sq_bits) == (8, 8)
    assert index.part_pad % 512 == 0
    assert checks["miss"]["value"] == 0.0 and checks["code_mismatch"]["value"] == 0.0
    assert result["metrics"]["recall_at_100"]["value"] > 0.5


def test_the_control_fails_a_limit(ran):
    _, checks, keep, _ = ran
    numbers = check.judge(keep["dep"], keep["got"], control=True)
    ok, shown = check.verdict(numbers, ADC8["limits"])
    assert not ok, shown
    assert numbers["dist_err"] > 10 * max(checks["dist_err"]["value"], ADC8["limits"]["dist_err"])


def _wrap(monkeypatch, alter):
    """Break the IVF conventional ADC search underneath the engine."""
    from qadc_tpu_torch.index import ivf

    def fault(ctx):
        real = ivf.search_adc

        def broken(*args, **kw):
            return alter(*real(*args, **kw))

        monkeypatch.setattr(ivf, "search_adc", broken)
    return fault


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    result, checks = tiny.run(root, CELL, seed=SEED + 1, seconds=0.5,
                              fault=_wrap(monkeypatch, FAULTS[fault]()))
    assert result["correct"] is False, checks
    assert any(v["value"] > v["limit"] for v in checks.values())


def test_a_broken_training_is_not_correct(root):
    with faults.planted("codebooks_at_seeds"):
        result, checks = tiny.run(root, CELL, seed=SEED + 2)
    assert result["correct"] is False, checks
    assert checks["train_excess"]["value"] > checks["train_excess"]["limit"]
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("miss", "dist_err", "code_mismatch")), checks


def test_the_reference_follows_the_ports_search_adc(ran):
    """Labels equal but where the screen's cut is tied; distances within
    1e-6 relative."""
    from qadc_tpu_torch.index import ivf

    dep = ran[2]["dep"]
    state, queries = dep.state(), dep.pool[:96]
    r, ma = ADC8["r"], ADC8["ma"]
    with reference.precision():
        want = reference.search_adc8(state, queries, r, ma)
    got_d, got_l = ivf.search_adc(dep.index, queries, r=r, ma=ma)
    assert torch.isfinite(want.dists).all()
    assert torch.allclose(got_d, want.dists, rtol=1e-6, atol=0.0)
    differ = (got_l.to(torch.int64) != want.labels).any(-1)
    tied = (want.code_class == reference.TIED).flatten(1).any(-1)
    assert not (differ & ~tied).any()
    assert differ.float().mean() <= 0.05


def test_8bit_codes_decode_as_the_port_stores_them(ran):
    dep = ran[2]["dep"]
    state = dep.state()
    assert (state.k, state.codes.shape[-1], state.cpr) == (256, 8, 16)
    ids = torch.randint(0, 256, (50, 8), generator=torch.Generator().manual_seed(5))
    assert torch.equal(reference.decode(ids.to(torch.uint8), 8, 256), ids)
    # Every stored code of the check vectors is the reference's encoding.
    part, want = reference.encode(state, dep.check_vectors)
    pos = check._positions(state)[dep.check_ids]
    stored = state.codes.reshape(-1, 8)[pos]
    assert torch.equal(pos // state.labels.shape[1], part)
    assert torch.equal(reference.decode(stored, 8, 256), want)
    assert torch.equal(stored, want.to(torch.uint8))


def test_the_tiny_adc8_cell_and_its_control_on_the_card(cuda, root):
    """The same cell on the CUDA kernels (kernel 5, grouped_scan8_sm.cu):
    correct, on the grouped path, and its control is not."""
    import time

    from portbench import harness
    from qadc_tpu_torch.eval.trace import recording

    keep = {}
    cell = harness.find_cell(CELL, root)
    with recording() as rec:
        result, checks = harness.run_cell(cell, SEED + 3, 0.5, False, cuda, time.perf_counter(),
                                          keep=keep)
    assert result["correct"] is True, checks
    assert {s.attrs.get("path") for s in rec.spans if s.name == "search"} == {"ivf.adc8"}
    numbers = check.judge(keep["dep"], keep["got"], control=True)
    ok, shown = check.verdict(numbers, ADC8["limits"])
    assert not ok, shown
