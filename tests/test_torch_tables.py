"""Front half of the search: qadc_tpu_torch vs qadc_tpu on the CPU.

Tolerances and why:
  - coarse assignment parts: equal (distinct distances at this data);
  - f32 tables: rtol 1e-5, atol 1e-4 (another BLAS, another sum order);
  - quantize_tables_int8 / keep_prefix_bound on IDENTICAL float inputs:
    exact (the same elementwise IEEE arithmetic and an exact selection);
  - int8 tables from each side's own float tables: >= 99.9% equal and never
    off by more than 1, since an ulp in a float entry or in the bound can
    tip one truncation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.index import ivf as jivf
from qadc_tpu.ops import quantization as jquant
from qadc_tpu.ops.tables import adc_tables as j_adc_tables
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.kernels.lut_scan import DISPATCH
from qadc_tpu_torch.ops import quantization
from qadc_tpu_torch.ops.tables import adc_tables
from torch_parity import as_np, synthetic_index, to_port, trained_index

MA = 4


@pytest.fixture(scope="module", params=["trained", "synthetic"])
def pair(request):
    if request.param == "trained":
        jindex, queries, _ = trained_index()
    else:
        jindex, queries = synthetic_index()
    return jindex, to_port(jindex), queries[:16]


def test_assign_queries_parts_equal(pair):
    jindex, tindex, queries = pair
    jp, jrot = jivf.assign_queries(jindex, queries, MA)
    tp, trot = ivf.assign_queries(tindex, torch.from_numpy(queries), MA)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(as_np(tp), as_np(jp))
    np.testing.assert_allclose(as_np(trot), as_np(jrot), rtol=1e-5, atol=1e-4)


def test_adc_tables_and_tiling(pair):
    jindex, tindex, queries = pair
    _, jrot = jivf.assign_queries(jindex, queries, MA)
    rot = np.array(jrot)
    jt = np.array(j_adc_tables(rot, jindex.pq.centroids))
    tt = adc_tables(torch.from_numpy(rot), tindex.pq.centroids)
    np.testing.assert_allclose(as_np(tt), jt, rtol=1e-5, atol=1e-4)
    m = jt.shape[-2]
    jlo, jhi = jivf.tile_tables_rows(jnp.asarray(jt.reshape(-1, m, 16)))
    tlo, thi = ivf.tile_tables_rows(torch.from_numpy(jt.reshape(-1, m, 16)))
    assert tlo.is_contiguous() and thi.is_contiguous()
    np.testing.assert_array_equal(as_np(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(as_np(thi), np.asarray(jhi))


def test_quantize_tables_int8_exact_on_identical_inputs():
    g = np.random.default_rng(3)
    tables = g.normal(loc=3.0, scale=2.0, size=(6, 4, 16, 16)).astype(np.float32)
    qmin = np.maximum(tables, 0).min(axis=(1, 2, 3)).astype(np.float32)
    qmax = (qmin + g.uniform(1.0, 20.0, size=6)).astype(np.float32)
    qmax[0] = qmin[0]  # zero-width range: every entry saturates to 127 or 0
    want = np.asarray(jquant.quantize_tables_int8(
        tables, qmax[:, None, None, None], qmin[:, None, None, None]))
    got = quantization.quantize_tables_int8(
        torch.from_numpy(tables), torch.from_numpy(qmax)[:, None, None, None],
        torch.from_numpy(qmin)[:, None, None, None])
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() <= 127


@pytest.mark.parametrize("width", [50, 100, 700])
def test_keep_prefix_bound_exact(width):
    g = np.random.default_rng(width)
    d = np.round(g.uniform(0, 50, size=(5, width)), 1).astype(np.float32)  # ties
    valid = g.uniform(size=d.shape) < 0.8
    want = np.asarray(jquant.keep_prefix_bound(d, 100, valid))
    got = quantization.keep_prefix_bound(torch.from_numpy(d), 100, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    bound = torch.tensor([np.inf, 4.0])
    clamped = quantization.clamp_bound_to_max_distance(bound, torch.tensor([10.0, 10.0]))
    np.testing.assert_array_equal(
        clamped.numpy(), np.asarray(jquant.clamp_bound_to_max_distance(
            jnp.asarray([np.inf, 4.0]), jnp.asarray([10.0, 10.0]))))


def test_quantized_tables_match(pair):
    jindex, tindex, queries = pair
    r, keep = 50, 0.05
    prefix_pad = min(max(1, int(jindex.max_part_size * keep)), jindex.part_pad)
    jp, jt, jq, _ = jivf._quantized_tables(
        jindex, jnp.asarray(queries), r, MA, keep, prefix_pad, interpret=True)
    tp, tt, tq, _ = ivf._quantized_tables(
        tindex, torch.from_numpy(queries), r, MA, keep, prefix_pad, DISPATCH)
    np.testing.assert_array_equal(as_np(tp), np.asarray(jp))
    np.testing.assert_allclose(as_np(tt), np.asarray(jt), rtol=1e-5, atol=1e-4)
    jq, tq = np.asarray(jq).astype(np.int32), as_np(tq).astype(np.int32)
    assert np.abs(jq - tq).max() <= 1
    assert (jq == tq).mean() >= 0.999, (jq != tq).sum()


def test_quantized_tables_bound_override(pair):
    jindex, tindex, queries = pair
    bound = np.linspace(5.0, 40.0, queries.shape[0]).astype(np.float32)
    _, jt, jq, _ = jivf._quantized_tables(
        jindex, jnp.asarray(queries), 50, MA, 0.05, 8, interpret=True,
        bound_override=jnp.asarray(bound))
    _, tt, tq, _ = ivf._quantized_tables(
        tindex, torch.from_numpy(queries), 50, MA, 0.05, 8, DISPATCH,
        bound_override=torch.from_numpy(bound))
    jq, tq = np.asarray(jq).astype(np.int32), as_np(tq).astype(np.int32)
    assert np.abs(jq - tq).max() <= 1
    assert (jq == tq).mean() >= 0.999
