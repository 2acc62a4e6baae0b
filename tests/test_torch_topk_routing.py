"""Routing invariants and the exact top-k screens vs qadc_tpu.

Tolerances: routing invariants exact; screen values exact and index sets
equal; ties go to the lower index, so with both sides running the same
stable cascades the indices are equal too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.ops import topk as jtopk
from qadc_tpu_torch.index.routing import group_capacity, route_queries
from qadc_tpu_torch.ops import topk

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)


@pytest.mark.parametrize("q,ma,p,g", [(1, 24, 256, 128), (32, 6, 16, 4),
                                      (50, 3, 7, 8), (5, 1, 64, 2)])
def test_route_queries_invariants(q, ma, p, g):
    parts = np.random.default_rng(q + ma).integers(0, p, size=(q, ma)).astype(np.int32)
    rb = route_queries(torch.from_numpy(parts), p, g)
    gcap = group_capacity(q, ma, p, g)
    assert rb.gcap == gcap and rb.group_size == g
    n_groups = int(rb.n_groups)
    assert 1 <= n_groups <= gcap
    np.testing.assert_array_equal(rb.group_valid.numpy(), np.arange(gcap) < n_groups)
    qg, qs = rb.qa_group.numpy().reshape(-1), rb.qa_slot.numpy().reshape(-1)
    assert (qg < n_groups).all() and (qs >= 0).all() and (qs < g).all()
    # every pair in exactly one slot, of a group of its own partition
    slots = qg * g + qs
    assert len(np.unique(slots)) == q * ma
    np.testing.assert_array_equal(rb.group_part.numpy()[qg], parts.reshape(-1))
    # slot_pairs is the inverse map; empty slots hold -1
    sp = rb.slot_pairs().numpy().reshape(-1)
    np.testing.assert_array_equal(sp[slots], np.arange(q * ma))
    assert (sp >= 0).sum() == q * ma
    # at most G per group, and live slots are a prefix of the group
    per = rb.slot_pairs().numpy() >= 0
    assert (per.sum(axis=1) <= g).all()
    assert (np.diff(per.astype(int), axis=1) <= 0).all()


def _tied_rows(shape, seed):
    g = np.random.default_rng(seed)
    return g.integers(0, 40, size=shape).astype(np.float32)  # heavy ties


@pytest.mark.parametrize("w,k", [(300, 100), (5000, 100), (3000, 7)])
def test_exact_screen_smallest_matches_reference(w, k):
    v = _tied_rows((3, w), w + k)
    jv, ji = jtopk.exact_screen_smallest(jnp.asarray(v), k)
    tv, ti = topk.exact_screen_smallest(torch.from_numpy(v), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("w,k", [(98304 // 8, 100), (20000, 64), (4000, 10)])
def test_exact_tile_screen_matches_reference(w, k):
    v = _tied_rows((2, w), w)
    v[:, 100:132] = np.inf  # a whole dead tile
    jv, ji = jtopk.exact_tile_screen(jnp.asarray(v), k)
    tv, ti = topk.exact_tile_screen(torch.from_numpy(v), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    mins = v.reshape(2, -1, 32).min(axis=-1)
    mv, mi = topk.exact_tile_screen(torch.from_numpy(v), k, mins=torch.from_numpy(mins))
    np.testing.assert_array_equal(mv.numpy(), tv.numpy())
    np.testing.assert_array_equal(mi.numpy(), ti.numpy())
    # lower-index-first among equal values
    for row_v, row_i in zip(tv.numpy(), ti.numpy()):
        same = row_v[1:] == row_v[:-1]
        assert (row_i[1:][same] > row_i[:-1][same]).all()


def test_exact_tile_screen_pads_short_rows():
    v = np.full((1, 4096), np.inf, np.float32)
    v[0, :5] = [3, 1, 2, 1, 0]
    jv, ji = jtopk.exact_tile_screen(jnp.asarray(v), 100,
                                     mins=jnp.asarray(v.reshape(1, -1, 32).min(-1)))
    tv, ti = topk.exact_tile_screen(torch.from_numpy(v), 100,
                                    mins=torch.from_numpy(v.reshape(1, -1, 32).min(-1)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy()[:, :5], np.asarray(ji)[:, :5])


@pytest.mark.parametrize("c,k", [(200, 100), (3000, 100)])
def test_topk_smallest_and_merge_match_reference(c, k):
    v = _tied_rows((4, c), c)
    lab = np.random.default_rng(1).permutation(4 * c).astype(np.int32).reshape(4, c)
    jv, jl = jtopk.topk_smallest(jnp.asarray(v), jnp.asarray(lab), k)
    tv, tl = topk.topk_smallest(torch.from_numpy(v), torch.from_numpy(lab), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    half = c // 2
    args = (v[:, :half], lab[:, :half], v[:, half:], lab[:, half:])
    jv, jl = jtopk.merge_topk(*map(jnp.asarray, args), k)
    tv, tl = topk.merge_topk(*map(torch.from_numpy, args), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
