"""The seeded inputs repeat: the device generators, the query order and the
sample that is judged."""

import numpy as np
import pytest
import torch

from portbench import check, deploy
from portbench.data import gist_moment, sift_moment
from portbench.loops import closed_batch

torch.set_num_threads(2)


@pytest.mark.parametrize("gen", [sift_moment, gist_moment], ids=["sift", "gist"])
def test_generators_repeat_from_the_seed(gen):
    dim = 128 if gen is sift_moment else 96

    def sets(seed):
        g = torch.Generator().manual_seed(seed)
        return gen.draw(g, [300, 50, 20], clusters=16, dim=dim)

    a, b, c = sets(deploy.subseed(2 ** 31 + 7, "data")), sets(deploy.subseed(2 ** 31 + 7, "data")), sets(5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert [x.shape for x in a] == [(300, dim), (50, dim), (20, dim)]
    if gen is sift_moment:
        assert torch.equal(a[0], a[0].round()) and a[0].min() >= 0 and a[0].max() <= 255
    else:
        assert a[0].min() >= 0 and a[0].max() <= 1


def test_generator_chunks_do_not_change_the_draw_shapes(monkeypatch):
    from portbench.data import common

    monkeypatch.setattr(common, "CHUNK_ROWS", 7)
    g = torch.Generator().manual_seed(3)
    (x,) = sift_moment.draw(g, [30], clusters=4)
    assert x.shape == (30, 128) and torch.isfinite(x).all()


def test_the_query_order_repeats_and_covers_the_pool():
    from types import SimpleNamespace

    def order(seed):
        return closed_batch._order(SimpleNamespace(seed=seed,
                                                   dep=SimpleNamespace(pool_np=np.zeros((500, 4)))))

    a, b, c = order(2 ** 31 + 11), order(2 ** 31 + 11), order(17)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(np.sort(a), np.arange(500))


def test_subseeds_differ_by_use_and_take_large_seeds():
    s = 2 ** 33 + 5
    assert deploy.subseed(s, "data") != deploy.subseed(s, "train")
    assert deploy.subseed(s, "data") == deploy.subseed(s, "data")
    assert 0 <= deploy.subseed(s, "data") < 2 ** 63


def test_the_judged_sample_repeats():
    qids = np.arange(1000)
    labels = [np.arange(5)[None] + i for i in range(1000)]
    a = check.sample(qids, labels, labels, 42, n=50)
    b = check.sample(qids, labels, labels, 42, n=50)
    assert np.array_equal(a.qids, b.qids) and np.array_equal(a.labels, b.labels)
    assert len(np.unique(a.qids)) == 50
