"""The Deep100M deployment (configs/deep100m-ivf4096-opq16x4.json) at a
tiny size on the CPU, its generator, its cell and its metrics.

A Deep-shaped configuration (deep_moment, 96-d, 8,000 base vectors, 64
lists, OPQ 16x4, ma 4, batches of 64) runs through deploy.build and the
closed loop's QueryEngine.run on the kernels' plain versions: check.py's
numbers against the plain reference sit inside the real configuration's
limits, and the control (int4 tables) does not. deep_moment.draw gives unit
vectors whose spectrum falls as stated, the same set for the same seed,
and the same set whatever the chunk.

    python -m pytest portbench/tests/test_portbench_deep.py
"""

import json
import time

import pytest
import torch

import tiny
from portbench import check, harness
from portbench.data import common, deep_moment

torch.set_num_threads(2)

PB = harness.ROOT / "portbench"
DEEP = json.loads((PB / "configs" / "deep100m-ivf4096-opq16x4.json").read_text())
TINY = dict(DEEP, name="tiny-deep", n_base=8000, n_learn=4000, n_queries=256,
            data={"generator": "deep_moment",
                  "params": dict(DEEP["data"]["params"], components=4096)},
            part_count=64, ma=4, r=20, keep=0.05, coarse_iters=5, opq_iters=1,
            kmeans_iters=4)
SEED = 2 ** 33 + 19


@pytest.fixture(scope="module")
def deep_root(tmp_path_factory):
    spec = tiny.spec()
    spec["configs"].append({"name": "tiny-deep", "source": "test", "why": "test",
                            "file": "portbench/configs/tiny-deep.json", "reduced": []})
    spec["workloads"].append({"name": "deep-b64", "config": "tiny-deep",
                              "traffic": "closed-b64", "chips": 1, "why": "test"})
    root = tiny.make_root(tmp_path_factory.mktemp("deep"), spec)
    (root / "portbench" / "configs" / "tiny-deep.json").write_text(json.dumps(TINY))
    (root / "portbench" / "traffic" / "closed-b64.json").write_text(
        json.dumps(dict(tiny.CLOSED, batch=64)))
    return root


@pytest.fixture(scope="module")
def ran(deep_root):
    keep = {}
    result, checks = tiny.run(deep_root, "deep-b64", seed=SEED, keep=keep)
    return result, checks, keep


def test_the_tiny_deployment_is_correct_against_the_reference(ran):
    result, checks, keep = ran
    assert result["correct"] is True, checks
    for name, limit in DEEP["limits"].items():
        assert checks[name]["value"] <= limit, (name, checks[name])
    dep = keep["dep"]
    assert dep.index.part_count == 64 and dep.index.pq.sq_count == 16
    assert dep.pool.shape == (256, 96)
    assert torch.allclose(dep.pool.norm(dim=1), torch.ones(256), atol=1e-5)
    assert result["metrics"]["recall_at_100"]["value"] > 0.2     # chance: 0.0025
    qids = keep["rec"].window.qids                # the pool is cycled: no repeat before its end
    assert len(set(qids.tolist())) == min(len(qids), 256)


def test_the_control_fails_a_limit(ran):
    _, checks, keep = ran
    numbers = check.judge(keep["dep"], keep["got"], control=True)
    ok, shown = check.verdict(numbers, DEEP["limits"])
    assert not ok, shown
    assert numbers["miss"] > 3 * max(checks["miss"]["value"], 0.01)


def test_the_new_metrics_read_the_record(ran):
    _, _, keep = ran
    rec = keep["rec"]
    read = {name: harness.load_module(PB / "metrics" / f"{name}.py", name).read
            for name in ("scan_ivf_hbm_roofline", "scan_ivf_roofline", "build_add_s",
                         "sort_device_share.b512", "sort_device_share.batch")}
    assert read["build_add_s"](rec) == keep["dep"].stages["add"] > 0
    assert read["scan_ivf_hbm_roofline"](rec) is None          # nothing traced
    assert read["sort_device_share.b512"](rec) is None
    rec.events = [("void grouped_scan_mma_kernel<8, 2>(...)", 0.0, 40.0),
                  ("void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<...>", 40.0, 50.0),
                  ("elementwise", 50.0, 100.0)]
    try:
        roof = read["scan_ivf_hbm_roofline"](rec)
        assert roof == read["scan_ivf_roofline"](rec) and roof > 0
        assert read["sort_device_share.b512"](rec) == read["sort_device_share.batch"](rec) == 0.1
    finally:
        rec.events = None


def _draw(seed, counts, **kw):
    return deep_moment.draw(torch.Generator().manual_seed(seed), counts, **kw)


def test_draw_gives_unit_vectors_of_the_stated_spectrum():
    base, learn, pool = _draw(SEED, [40_000, 300, 7], components=4096)
    assert [t.shape for t in (base, learn, pool)] == [(40_000, 96), (300, 96), (7, 96)]
    for t in (base, learn, pool):
        assert t.dtype == torch.float32
        assert (t.norm(dim=1) - 1.0).abs().max() <= 1e-5
    # Variance falls with the dimension's index as (d + 1) ** -decay: the
    # slope of log variance over log (d + 1), fitted by least squares.
    for decay in (1.0, 2.0):
        x, = _draw(SEED, [40_000], components=4096, decay=decay)
        logd = torch.log(torch.arange(1, 97, dtype=torch.float64))
        logv = torch.log(x.double().var(0))
        slope = ((logd - logd.mean()) * (logv - logv.mean())).sum() / ((logd - logd.mean()) ** 2).sum()
        assert abs(slope + decay) < 0.1, (decay, float(slope))
        assert bool((logv[:8].diff() < 0).all())


def test_draw_repeats_for_a_seed_and_differs_across_seeds():
    a = _draw(SEED, [500, 60], components=64)
    b = _draw(SEED, [500, 60], components=64)
    c = _draw(SEED + 1, [500, 60], components=64)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_a_chunked_draw_equals_an_unchunked_one(monkeypatch):
    monkeypatch.setattr(deep_moment, "BLOCK_ROWS", 16)
    monkeypatch.setattr(common, "CHUNK_ROWS", 1 << 20)
    whole = _draw(SEED, [100, 37, 50], components=64)
    monkeypatch.setattr(common, "CHUNK_ROWS", 32)
    chunked = _draw(SEED, [100, 37, 50], components=64)
    assert all(torch.equal(x, y) for x, y in zip(whole, chunked))
    monkeypatch.setattr(common, "CHUNK_ROWS", 24)
    with pytest.raises(ValueError):
        _draw(SEED, [10], components=64)


def test_the_cell_keeps_the_published_geometry():
    assert DEEP["reduced"] == ["n_base", "n_learn", "n_queries"]
    assert set(DEEP["reduced_why"]) == set(DEEP["reduced"])
    assert {"data", "components", "spectrum"} <= set(DEEP["assumed"])
    assert len(DEEP["source"]) <= 200
    assert (DEEP["dim"], DEEP["sq_count"], DEEP["sq_bits"], DEEP["part_count"], DEEP["ma"],
            DEEP["r"], DEEP["keep"]) == (96, 16, 4, 4096, 24, 100, 0.005)
    assert (DEEP["n_base"], DEEP["n_learn"], DEEP["n_queries"]) == (10 ** 8, 10 ** 6, 40_000)
    cell = harness.find_cell("deep100m-ivf-b512")
    assert cell.traffic == {"loop": "closed_batch", "batch": 512, "warm_batches": 5}
    assert cell.workload["chips"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"qps", "recall_at_100", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "scan_ivf_hbm_roofline", "sort_device_share.b512", "build_add_s"}
    for name in ("sift1m-ivf-b128", "gist1m-flat-b128"):
        assert not {"scan_ivf_hbm_roofline", "sort_device_share.b512", "build_add_s"} & {
            m["name"] for m in harness.find_cell(name).per_layer}


def test_the_tiny_deployment_and_its_control_on_the_card(cuda, deep_root):
    keep = {}
    cell = harness.find_cell("deep-b64", deep_root)
    result, checks = harness.run_cell(cell, SEED, 0.5, False, cuda, time.perf_counter(),
                                      keep=keep)
    assert result["correct"] is True, checks
    numbers = check.judge(keep["dep"], keep["got"], control=True)
    ok, shown = check.verdict(numbers, DEEP["limits"])
    assert not ok, shown
