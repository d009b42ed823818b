"""Port parity of the dense oracles and the sweep boundaries:
``repro_torch.kernels.ref.spmm_ref`` / ``spmspm_ref`` against
``repro.kernels.ref`` within 1e-5 (f32; only the order of summation
differs), ``repro_torch.kernels.accum.tile_bounds`` exactly equal to the
reference's over whole grids.  Operands are numpy arrays from a seed over
the golden patterns of ``core/sparsity.py``, fed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.core.sparsity import block_pattern_mask, element_pattern_mask
from repro.kernels import accum as ref_accum
from repro.kernels import ref as ref_ref
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels.accum import tile_bounds
from repro_torch.kernels.ref import spmm_ref, spmspm_ref

TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ["uniform", "power_law", "banded", "empty_rows", "all_zero"]


def _mask(kind, rng, gm, gk, pattern=block_pattern_mask):
    if kind == "empty_rows":
        mask = rng.random((gm, gk)) < 0.5
        mask[::2] = False
        return mask
    if kind == "all_zero":
        return np.zeros((gm, gk), bool)
    return pattern(kind, rng, gm, gk)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_spmm_ref_equals_reference(kind, dtype):
    rng = np.random.default_rng(3)
    gm, gk, bm, bk, n = 6, 5, 8, 4, 7
    mask = _mask(kind, rng, gm, gk)
    d = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    cap = max(int(mask.sum()), 1) + 3             # pad slots past nnzb
    ref_a = RefBlockCSR.from_dense(d, (bm, bk), n_blocks_max=cap)
    a = BlockCSR.from_dense(d, (bm, bk), n_blocks_max=cap, device="cpu")
    b = rng.standard_normal((gk * bk, n)).astype(np.float32)
    if dtype == "bfloat16":
        want = ref_ref.spmm_ref(ref_a.blocks.astype(jnp.bfloat16),
                                ref_a.block_row, ref_a.block_col,
                                jnp.asarray(b, jnp.bfloat16), m=gm * bm)
        got = spmm_ref(a.blocks.bfloat16(), torch.from_numpy(a.block_row),
                       torch.from_numpy(a.block_col),
                       torch.from_numpy(b).bfloat16(), m=gm * bm)
        assert got.dtype == torch.bfloat16
        want32 = np.asarray(want.astype(jnp.float32))
        assert np.abs(got.float().numpy() - want32).max() \
            <= 1e-2 * max(np.abs(want32).max(), 1.0)
        return
    want = ref_ref.spmm_ref(ref_a.blocks, ref_a.block_row, ref_a.block_col,
                            jnp.asarray(b), m=gm * bm)
    got = spmm_ref(a.blocks, torch.from_numpy(a.block_row),
                   torch.from_numpy(a.block_col), torch.from_numpy(b),
                   m=gm * bm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), d @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_spmspm_ref_equals_reference(kind):
    rng = np.random.default_rng(4)
    m, k, n = 12, 10, 6
    mask = _mask(kind, rng, m, k, pattern=element_pattern_mask)
    slots = max(int(mask.sum(axis=1).max(initial=0)), 1) + 1
    values = np.zeros((m, slots), np.float32)
    col_ids = np.full((m, slots), -1, np.int32)
    for i in range(m):
        cols = np.nonzero(mask[i])[0]
        col_ids[i, :cols.size] = cols
        values[i, :cols.size] = rng.standard_normal(cols.size)
    values[col_ids < 0] = rng.standard_normal(int((col_ids < 0).sum()))
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = ref_ref.spmspm_ref(jnp.asarray(values), jnp.asarray(col_ids),
                              jnp.asarray(b))
    got = spmspm_ref(torch.from_numpy(values), torch.from_numpy(col_ids),
                     torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = np.zeros((m, k), np.float32)
    live = col_ids >= 0
    dense[np.nonzero(live)[0], col_ids[live]] = values[live]
    np.testing.assert_allclose(got.numpy(), dense @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_g,n_j", [(1, 1), (1, 4), (3, 1), (3, 5)])
def test_tile_bounds_equals_reference(n_g, n_j):
    g, j = np.meshgrid(np.arange(n_g), np.arange(n_j), indexing="ij")
    want = ref_accum.tile_bounds(jnp.asarray(g), jnp.asarray(j), n_g, n_j)
    got = tile_bounds(g, j, n_g, n_j)
    for w, o in zip(want, got):
        assert np.array_equal(np.asarray(w), o)
    assert int(got[0].sum()) == int(got[1].sum()) == 1
    for gi in range(n_g):                         # scalar visits alike
        for ji in range(n_j):
            first, last = tile_bounds(gi, ji, n_g, n_j)
            assert (bool(first), bool(last)) == (
                bool(got[0][gi, ji]), bool(got[1][gi, ji]))
