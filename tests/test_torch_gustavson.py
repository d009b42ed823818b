"""Port parity of ``core/gustavson.py``: the row-wise product oracles
(``spmm_rowwise``, ``spmspm_rowwise``, ``spmspm_rowwise_scan``,
``dense_oracle``) against ``repro`` on the CPU.

Values and value gradients agree within 1e-5 (f32 sums in another
order: the port adds each output entry's terms in slot order where the
reference scatter-adds).  The port's sums are pinned exactly: each
output row equals a sequential f32 sum of its terms in slot order, and
two runs are bit-identical.  Operands are built in numpy from a seed and
carried across with ``convert.csr_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gustavson as RG
from repro.core.csr import CSR as RefCSR
from repro.core.sparsity import element_pattern_mask
from repro_torch.convert import csr_from_numpy
from repro_torch.core import gustavson as G

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(ref):
    return csr_from_numpy(np.asarray(ref.value), np.asarray(ref.col_id),
                          np.asarray(ref.row_ptr), ref.shape, device="cpu")


def _dense(kind, m, k, seed, empty_rows=()):
    rng = np.random.default_rng(seed)
    mask = element_pattern_mask(kind, rng, m, k)
    d = (mask * rng.standard_normal((m, k))).astype(np.float32)
    d[list(empty_rows)] = 0
    return d


def _pair(ad, pad=0):
    ref = RefCSR.from_dense(ad, nnz_max=int((ad != 0).sum()) + pad) \
        if (ad != 0).any() else RefCSR.from_dense(ad, nnz_max=max(pad, 1))
    return ref, _port(ref)


CASES = [  # (kind, m, k, n, A pad slots, A empty rows)
    ("uniform", 24, 16, 20, 0, ()),
    ("power_law", 32, 24, 12, 5, (3, 7)),
    ("banded", 16, 16, 16, 3, (0, 15)),
    ("uniform", 8, 8, 8, 2, tuple(range(8))),          # all-zero A
]


@pytest.mark.parametrize("kind,m,k,n,pad,empty", CASES)
def test_spmm_rowwise_matches_reference(kind, m, k, n, pad, empty):
    ra, pa = _pair(_dense(kind, m, k, 0, empty), pad)
    b = np.random.default_rng(1).standard_normal((k, n)).astype(np.float32)
    want = np.asarray(RG.spmm_rowwise(ra, jnp.asarray(b)))
    got = G.spmm_rowwise(pa, torch.from_numpy(b))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, G.spmm_rowwise(pa, torch.from_numpy(b)))


@pytest.mark.parametrize("kind,m,k,n,pad,empty", CASES)
def test_spmspm_oracles_match_reference(kind, m, k, n, pad, empty):
    ra, pa = _pair(_dense(kind, m, k, 2, empty), pad)
    rb, pb = _pair(_dense(kind, k, n, 3, (1,)), 4)
    for name, kw in (("spmspm_rowwise", {}), ("dense_oracle", {}),
                     ("spmspm_rowwise_scan", {"row_chunk": 8}),
                     ("spmspm_rowwise_scan", {"row_chunk": m})):
        want = np.asarray(getattr(RG, name)(ra, rb, **kw))
        got = getattr(G, name)(pa, pb, **kw)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)
        assert torch.equal(got, getattr(G, name)(pa, pb, **kw)), name


def test_rows_sum_in_slot_order():
    """Each output row is 0 + t_0 + t_1 + … over its slots in slot order,
    in f32 (the order the port promises, bit for bit)."""
    rng = np.random.default_rng(4)
    ad = _dense("power_law", 12, 40, 5)
    ad[ad != 0] *= 10.0 ** rng.integers(-4, 5, int((ad != 0).sum()))
    ra, pa = _pair(ad, 3)
    b = (rng.standard_normal((40, 6)) * 10.0 ** rng.integers(
        -3, 4, (40, 1))).astype(np.float32)
    got = G.spmm_rowwise(pa, torch.from_numpy(b)).numpy()
    want = np.zeros_like(got)
    rptr, cols, vals = pa.row_ptr, pa.col_id, pa.value.numpy()
    for i in range(ad.shape[0]):
        for s in range(rptr[i], rptr[i + 1]):
            want[i] = want[i] + b[cols[s]] * vals[s]
    assert np.array_equal(got, want)


def test_the_raising_cases_match_reference():
    ra, pa = _pair(_dense("uniform", 12, 8, 6))
    rb, pb = _pair(_dense("uniform", 6, 5, 7))
    b = np.zeros((6, 3), np.float32)
    for ref_call, call in (
            (lambda: RG.spmm_rowwise(ra, jnp.asarray(b)),
             lambda: G.spmm_rowwise(pa, torch.from_numpy(b))),
            (lambda: RG.spmspm_rowwise(ra, rb),
             lambda: G.spmspm_rowwise(pa, pb)),
            (lambda: RG.spmspm_rowwise_scan(ra, rb, row_chunk=4),
             lambda: G.spmspm_rowwise_scan(pa, pb, row_chunk=4))):
        with pytest.raises(ValueError, match="shape mismatch") as want:
            ref_call()
        with pytest.raises(ValueError, match="shape mismatch") as got:
            call()
        assert str(got.value) == str(want.value)
    rc, pc = _pair(_dense("uniform", 8, 5, 8))
    with pytest.raises(ValueError) as want:
        RG.spmspm_rowwise_scan(ra, rc, row_chunk=5)
    with pytest.raises(ValueError) as got:
        G.spmspm_rowwise_scan(pa, pc, row_chunk=5)
    assert str(got.value) == str(want.value) == \
        "n_rows=12 not divisible by row_chunk=5"


@pytest.mark.parametrize("name,kw", [("spmspm_rowwise", {}),
                                     ("spmspm_rowwise_scan",
                                      {"row_chunk": 4}),
                                     ("dense_oracle", {})])
def test_value_gradients_match_jax_grad(name, kw):
    ra, pa = _pair(_dense("power_law", 16, 12, 6, (2,)), 3)
    rb, pb = _pair(_dense("banded", 12, 10, 7), 2)
    w = np.random.default_rng(8).standard_normal((16, 10)).astype(np.float32)

    def ref_loss(av, bv):
        a = RefCSR(av, ra.col_id, ra.row_ptr, ra.shape)
        b = RefCSR(bv, rb.col_id, rb.row_ptr, rb.shape)
        return jnp.sum(getattr(RG, name)(a, b, **kw) * w)

    ga, gb = jax.grad(ref_loss, argnums=(0, 1))(ra.value, rb.value)
    av = pa.value.clone().requires_grad_()
    bv = pb.value.clone().requires_grad_()
    out = getattr(G, name)(dataclasses.replace(pa, value=av),
                           dataclasses.replace(pb, value=bv), **kw)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(av.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(bv.grad.numpy(), np.asarray(gb), **TOL)


def test_spmm_rowwise_gradients_match_jax_grad():
    ra, pa = _pair(_dense("uniform", 20, 14, 9, (0, 5)), 4)
    b = np.random.default_rng(10).standard_normal((14, 6)).astype(np.float32)
    w = np.random.default_rng(11).standard_normal((20, 6)).astype(np.float32)
    ga, gb = jax.grad(lambda av, bd: jnp.sum(RG.spmm_rowwise(
        RefCSR(av, ra.col_id, ra.row_ptr, ra.shape), bd) * w),
        argnums=(0, 1))(ra.value, jnp.asarray(b))
    av = pa.value.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (G.spmm_rowwise(dataclasses.replace(pa, value=av), bt)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(av.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), **TOL)
    assert not av.grad[pa.nnz:].any()          # pad slots get no gradient
