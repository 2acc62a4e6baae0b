"""Kernel M2 (rows_adc): the plain version vs qadc_tpu's rows_adc in
interpret mode (rows_adc_accumulate + the selector matmul), on identical
rows and tables, and the wrapper's argument checks.

Tolerance: rtol 1e-6, atol 1e-5 * max|ref|: float32 sums of 16 terms taken
in another order than the reference's lane sums and HIGHEST matmul.

The id lists of the staged kernel's cases (test_torch_rows_adc_tiles.ID_LISTS:
one pair for every row, runs a tile boundary cuts, every pair distinct,
pairs descending, repeated row ids, A = 1 and A = 0) go through both
packages too; at A = 0 the reference's kernel takes no input, and the port
returns (0, cpr).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.index import ivf as jivf
from qadc_tpu_torch.kernels import lut_scan
from test_torch_rows_adc_tiles import ID_CASES, id_list_inputs

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)


def _inputs(cb, a, seed=0):
    g = np.random.default_rng(seed)
    codes = g.integers(0, 256, size=(97, 128), dtype=np.uint8)
    row_ids = g.integers(0, 97, size=a).astype(np.int32)
    pair_ids = g.integers(0, 13, size=a).astype(np.int32)
    tlo = g.uniform(0, 30, size=(13, 16 * cb)).astype(np.float32)
    thi = g.uniform(0, 30, size=(13, 16 * cb)).astype(np.float32)
    return codes, row_ids, pair_ids, tlo, thi


@pytest.mark.parametrize("cb,a", [(8, 700), (8, 512), (16, 300)])
def test_rows_adc_matches_reference(cb, a):
    codes, row_ids, pair_ids, tlo, thi = _inputs(cb, a, seed=cb + a)
    want = np.asarray(jivf.rows_adc(
        jnp.asarray(codes[row_ids]), jnp.asarray(tlo[pair_ids]),
        jnp.asarray(thi[pair_ids]), cb, interpret=True))
    got = lut_scan.rows_adc_plain(*map(torch.from_numpy, (codes, row_ids, pair_ids, tlo, thi)))
    assert got.shape == (a, 128 // cb) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("name,a", ID_CASES)
def test_rows_adc_id_lists_match_reference(name, a, cb):
    codes, row_ids, pair_ids, tlo, thi = id_list_inputs(name, a, cb)
    got = lut_scan.rows_adc_plain(codes, row_ids, pair_ids, tlo, thi)
    assert got.shape == (a, 128 // cb) and got.dtype == torch.float32
    if a == 0:
        return
    r, p = row_ids.long(), pair_ids.long()
    want = np.asarray(jivf.rows_adc(jnp.asarray(codes[r].numpy()), jnp.asarray(tlo[p].numpy()),
                                    jnp.asarray(thi[p].numpy()), cb, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5 * np.abs(want).max())
    assert torch.equal(lut_scan.rows_adc(codes, row_ids, pair_ids, tlo, thi), got)


def test_rows_adc_dispatches_to_plain_on_cpu():
    args = [torch.from_numpy(x) for x in _inputs(8, 40)]
    before = dict(lut_scan.launches)
    torch.testing.assert_close(lut_scan.rows_adc(*args), lut_scan.rows_adc_plain(*args),
                               rtol=0, atol=0)
    assert lut_scan.launches == before  # counts only kernel launches


def test_rows_adc_checks_arguments():
    codes, row_ids, pair_ids, tlo, thi = map(torch.from_numpy, _inputs(8, 10))
    with pytest.raises(TypeError):
        lut_scan.rows_adc(codes, row_ids.long(), pair_ids, tlo, thi)
    with pytest.raises(ValueError):
        lut_scan.rows_adc(codes, row_ids, pair_ids, tlo[:, :100], thi[:, :100])
    with pytest.raises(ValueError):
        lut_scan.rows_adc(codes, row_ids, pair_ids[:5], tlo, thi)
    with pytest.raises(ValueError):
        lut_scan.rows_adc(codes, row_ids, pair_ids, tlo.T.contiguous().T, thi)
    with pytest.raises(RuntimeError):  # no kernel for this device
        meta = [t.to("meta") for t in (codes, row_ids, pair_ids, tlo, thi)]
        lut_scan.rows_adc(*meta)
