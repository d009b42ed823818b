"""Port parity: similarity row reordering (``repro_torch.kernels.reorder``)
against ``repro.kernels.reorder``.

The permutation, its inverse, the refined block pattern, the payload
gather maps, the occupancy digest and the plans built on the permuted
pattern are exactly the reference's.  Within the port a row-atomic
reordered run equals the unpermuted one bit for bit, a chunked one agrees
to f32 reassociation, and positions the refined pattern drops get zero
gradient (the reference's contract); values agree with the reference
within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.core.sparsity import block_pattern_mask
from repro.kernels import maple_spmm as ref_maple_spmm
from repro.kernels import reorder as ref_reorder
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels import maple_spmm, plan_spmm, plan_spmm_vjp
from repro_torch.kernels import reorder

GM, GK, BM, BK = 6, 6, 4, 4
KINDS = ("uniform", "power_law", "banded", "empty_rows", "interleaved")
PLAN_FIELDS = ("order", "step_row", "step_col", "written", "step_acc",
               "flush_slot", "slot_row", "row_mask", "r_max")


def _dense(kind, seed=0):
    """A golden pattern, thinned inside live blocks; ``interleaved`` has
    even and odd rows on disjoint column halves, so grouping them halves
    the live block count."""
    rng = np.random.default_rng(seed)
    m, k = GM * BM, GK * BK
    d = rng.standard_normal((m, k)).astype(np.float32)
    if kind == "interleaved":
        keep = np.zeros((m, k), bool)
        keep[0::2, :k // 2] = True
        keep[1::2, k // 2:] = True
        return d * keep
    mask = block_pattern_mask("uniform" if kind == "empty_rows" else kind,
                              rng, GM, GK)
    if kind == "empty_rows":
        mask[1] = mask[4] = False
    d *= np.repeat(np.repeat(mask, BM, 0), BK, 1)
    return d * (rng.random(d.shape) < 0.5)


def _both(kind, seed=0):
    d = _dense(kind, seed)
    return (RefBlockCSR.from_dense(d, (BM, BK)),
            BlockCSR.from_dense(d, (BM, BK), device="cpu"), d)


def _rhs(seed, k=GK * BK, n=8):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_reorder_rows_and_digest_equal_reference(kind):
    ref_a, a, d = _both(kind, seed=KINDS.index(kind))
    want, got = ref_reorder.reorder_rows(ref_a), reorder.reorder_rows(a)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, np.ndarray):
            assert g.dtype == np.asarray(w).dtype, f.name
            assert np.array_equal(g, np.asarray(w)), f.name
        else:
            assert g == w, f.name
    assert reorder.occupancy_digest(a) == ref_reorder.occupancy_digest(ref_a)
    np.testing.assert_array_equal(np.sort(got.perm), np.arange(GM * BM))
    np.testing.assert_array_equal(got.perm[got.inv], np.arange(GM * BM))
    ap = reorder.apply_reorder(a, got)
    ap.check_pad_contract()
    np.testing.assert_array_equal(ap.to_dense().numpy(), d[got.perm])
    if kind == "interleaved":
        assert got.n_blocks * 2 == a.nnzb and got.density_after == 1.0


@pytest.mark.parametrize("kw", [dict(row_atomic=True), dict(),
                                dict(n_lanes=3, chunk=1)])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_reordered_spmm_equals_reference(kind, kw):
    ref_a, a, _ = _both(kind, seed=KINDS.index(kind))
    want = ref_reorder.plan_reordered_spmm(ref_a, **kw)
    got = reorder.plan_reordered_spmm(a, **kw)
    for f in PLAN_FIELDS:
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), f
    assert got.fused == want.fused == "rmw"
    assert np.array_equal(got.reorder.perm, want.reorder.perm)


@pytest.mark.parametrize("kind", KINDS)
def test_reordered_runs_match_unpermuted_and_reference(kind):
    ref_a, a, d = _both(kind, seed=10 + KINDS.index(kind))
    b = _rhs(3)
    bt = torch.from_numpy(b)
    for fused in ("rmw", "compact"):
        base = maple_spmm(a, bt, plan=plan_spmm(a, row_atomic=True,
                                                fused=fused))
        out = maple_spmm(a, bt, plan=reorder.plan_reordered_spmm(
            a, row_atomic=True, fused=fused))
        assert torch.equal(out, base), fused
        chunked = maple_spmm(a, bt, plan=reorder.plan_reordered_spmm(
            a, n_lanes=3, chunk=1, fused=fused))
        torch.testing.assert_close(chunked, base, rtol=1e-5, atol=1e-5)
    ref = np.asarray(ref_maple_spmm(
        ref_a, jnp.asarray(b),
        plan=ref_reorder.plan_reordered_spmm(ref_a, n_lanes=3, chunk=1)))
    np.testing.assert_allclose(chunked.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(base.numpy(), d @ b, rtol=1e-4, atol=1e-4)


def test_dropped_positions_get_zero_gradient():
    """A reordered train plan gives the unreordered gradient wherever the
    refined pattern covers a position, and exactly zero elsewhere."""
    _, a, _ = _both("interleaved", seed=5)
    rr = reorder.reorder_rows(a)
    bt = torch.from_numpy(_rhs(5))
    grads = []
    for train in (plan_spmm_vjp(reorder.pattern_standin(rr),
                                fwd=reorder.plan_reordered_spmm(a, rr)),
                  plan_spmm_vjp(a)):
        blocks = a.blocks.clone().requires_grad_()
        out = maple_spmm(dataclasses.replace(a, blocks=blocks), bt,
                         plan=train)
        (out ** 2).sum().backward()
        grads.append(blocks.grad.numpy())
    g_rr, g = grads
    nnzb_p = rr.n_blocks
    cov = np.zeros(g.shape[:2], bool)
    live = rr.src_live[:nnzb_p]
    cov[rr.src_block[:nnzb_p][live], rr.src_row[:nnzb_p][live]] = True
    np.testing.assert_allclose(g_rr[cov], g[cov], rtol=1e-5, atol=1e-4)
    assert not g_rr[~cov].any()
    assert (~cov).any() and cov.any()


def test_reorder_misuse_raises_like_the_reference():
    ref_a, a, _ = _both("uniform")
    _, other, _ = _both("uniform", seed=1)
    rr = reorder.reorder_rows(a)
    small = BlockCSR.from_dense(np.ones((8, 8), np.float32), (BM, BK),
                                device="cpu")
    with pytest.raises(ValueError, match="built for"):
        reorder.apply_reorder(small, rr)
    with pytest.raises(ValueError, match="built for this weight"):
        maple_spmm(small, torch.zeros((8, 4)),
                   plan=reorder.plan_reordered_spmm(a, rr))
    for fn, op, b in ((ref_maple_spmm, ref_a, jnp.zeros((GK * BK, 4))),
                      (maple_spmm, a, torch.zeros((GK * BK, 4)))):
        with pytest.raises(ValueError, match="requires plan='auto'"):
            fn(op, b, reorder=True)
    assert reorder.occupancy_digest(a) != reorder.occupancy_digest(other)
