"""The port's autotune (qadc_tpu_torch/autotune.py) on the CPU: buckets and
keys against qadc_tpu's, the cache round trip, picks consumed by
ivf.search_qadc, and the tuner's decisions.

The tuner tests replace the module's timing function with a deterministic
one, so none of them depends on the load of the machine. Tolerance: exact.
"""

import json

import numpy as np
import pytest
import torch

from qadc_tpu import autotune as jautotune
from qadc_tpu_torch import autotune
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.ops.knn import assign_nearest
from qadc_tpu_torch.quantizers.pq import train_pq

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    """A 16x4 IVF-8 index of 5,000 x 32 vectors (numpy seed 7), part_pad a
    multiple of 512, so search_qadc takes the grouped path on the CPU."""
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.normal(scale=2.0, size=(5000, 32)).astype(np.float32))
    coarse = ivf.train_coarse(0, base[:2000], 8, iters=6)
    a = assign_nearest(base[:2000], coarse).long()
    pq = train_pq(1, base[:2000] - coarse[a], 16, 4, iters=6)
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    assert index.part_pad % 512 == 0
    return index, base[:8] + 0.01


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QADC_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("QADC_AUTOTUNE", raising=False)
    monkeypatch.setattr(autotune, "_mem", {})
    monkeypatch.setattr(autotune, "_disk_loaded", False)


def test_batch_bucket_matches_the_reference():
    assert [autotune.batch_bucket(q) for q in range(1, 4097)] == [
        jautotune.batch_bucket(q) for q in range(1, 4097)]


def test_key_names_the_device(built, monkeypatch):
    index, queries = built
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    assert key == (f"cpu|ivf_qadc_grouped|m16x4|d32|pp{index.part_pad}|parts8|b8")

    class OnCard:
        pq = index.pq
        part_pad, part_count = 12288, 256
        device = torch.device("cuda", 0)

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert autotune.geometry_key(OnCard(), "ivf_qadc_grouped", 32) == (
        "NVIDIA H100 80GB HBM3|ivf_qadc_grouped|m16x4|d32|pp12288|parts256|b32")


def test_record_lookup_and_disk_round_trip(built, tmp_path):
    index, queries = built
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    assert autotune.lookup(key) == {}
    autotune.record(key, {"group_size": 64})
    assert autotune.lookup(key) == {"group_size": 64}
    autotune._mem.clear()  # a fresh process reads the pick from disk
    autotune._disk_loaded = False
    assert autotune.lookup(key) == {"group_size": 64}
    with open(tmp_path / "autotune.json") as f:
        assert json.load(f) == {key: {"group_size": 64}}


def test_the_jax_defaults_file_is_never_read(monkeypatch, tmp_path):
    opened = []
    real_open = open

    def spy(path, *args, **kwargs):
        opened.append(str(path))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(autotune, "open", spy, raising=False)
    bundled = "tpu|ivf_qadc_grouped|m16x4|d128|pp4096|parts256|b32"
    with open(jautotune._bundled_defaults_path()) as f:
        assert bundled in json.load(f)  # the JAX package ships it
    opened.clear()
    assert autotune.lookup(bundled) == {}
    assert opened == [str(tmp_path / "autotune.json")]
    monkeypatch.delenv("QADC_AUTOTUNE_CACHE")
    assert autotune._cache_path().endswith("/.cache/qadc_tpu_torch/autotune.json")


def _spy_lookup(monkeypatch):
    seen = {}
    real = autotune.lookup

    def spy(key):
        seen[key] = real(key)
        return seen[key]

    monkeypatch.setattr(autotune, "lookup", spy)
    return seen


def test_recorded_pick_is_applied_and_changes_no_result(built, monkeypatch):
    index, queries = built
    d0, l0 = ivf.search_qadc(index, queries, r=20, ma=4, keep=0.05, group_size=128)
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    autotune.record(key, {"group_size": 2})
    seen = _spy_lookup(monkeypatch)
    used = []
    real_route = ivf.route_queries
    monkeypatch.setattr(ivf, "route_queries",
                        lambda p, n, g: used.append(g) or real_route(p, n, g))
    d1, l1 = ivf.search_qadc(index, queries, r=20, ma=4, keep=0.05)
    assert seen == {key: {"group_size": 2}} and used == [2]
    assert torch.equal(l0, l1) and torch.equal(d0, d1)


def test_explicit_group_size_bypasses_the_cache(built, monkeypatch):
    index, queries = built
    seen = _spy_lookup(monkeypatch)
    ivf.search_qadc(index, queries, r=20, ma=4, keep=0.05, group_size=64)
    ivf.search_qadc(index, queries, r=20, ma=4, keep=0.05, grouped=False)
    assert seen == {}
    with pytest.raises(ValueError, match="group_size"):
        ivf.search_qadc(index, queries, r=20, ma=4, keep=0.05, group_size=0)


def test_enabled_tunes_on_the_first_search(built, monkeypatch):
    index, queries = built
    monkeypatch.setenv("QADC_AUTOTUNE", "1")
    calls = []

    def fake_tune(idx, qs, r, ma, keep):
        calls.append((r, ma, keep))
        return {"group_size": 32}

    monkeypatch.setattr(autotune, "tune_ivf_qadc", fake_tune)
    ivf.search_qadc(index, queries, r=20, ma=4, keep=0.05)
    assert calls == [(20, 4, 0.05)]


@pytest.mark.parametrize("capturing", [False, True])
def test_a_search_captured_into_a_graph_does_not_tune(monkeypatch, capturing):
    """Under QADC_AUTOTUNE=1 a card search tunes unless its stream is being
    captured (tuning synchronises); on the CPU the switch alone decides."""
    monkeypatch.setenv("QADC_AUTOTUNE", "1")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    assert autotune.enabled("cuda") is not capturing
    assert autotune.enabled(torch.device("cpu"))
    monkeypatch.delenv("QADC_AUTOTUNE")
    assert not autotune.enabled("cuda")


def _fake_times(monkeypatch, times):
    calls = []

    def fake(index, queries, group_size, iters, **kw):
        calls.append((group_size, iters))
        if group_size not in times:
            raise ValueError(f"no kernel takes group_size={group_size}")
        return times[group_size]

    monkeypatch.setattr(autotune, "_time_group_size", fake)
    return calls


def test_tuner_records_a_confirmed_win(built, monkeypatch):
    index, queries = built
    calls = _fake_times(monkeypatch, {32: 1.0e-3, 64: 0.5e-3, 128: 1.0e-3})
    pick = autotune.tune_ivf_qadc(index, queries, r=20, ma=4, keep=0.05,
                                  group_candidates=(0, 32, 64, 128), iters=5)
    assert pick == {"group_size": 64}
    # each candidate once, then the winner and the default at twice the iterations
    assert calls == [(0, 5), (32, 5), (64, 5), (128, 5), (64, 10), (128, 10)]
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    assert autotune.lookup(key) == pick


def test_tuner_rejects_a_win_under_three_percent(built, monkeypatch):
    index, queries = built
    _fake_times(monkeypatch, {64: 0.98e-3, 128: 1.0e-3})
    assert autotune.tune_ivf_qadc(index, queries, r=20, ma=4, keep=0.05,
                                  group_candidates=(64, 128)) == {}
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    assert autotune.lookup(key) == {}
    _fake_times(monkeypatch, {})
    assert autotune.tune_ivf_qadc(index, queries, r=20, ma=4, keep=0.05) == {}


def test_tuner_times_the_real_search(built):
    """One candidate, the default: the real timing path runs and its pick
    is recorded without a confirmation."""
    index, queries = built
    pick = autotune.tune_ivf_qadc(index, queries, r=20, ma=4, keep=0.05,
                                  group_candidates=(128,), iters=2)
    assert pick == {"group_size": 128}
