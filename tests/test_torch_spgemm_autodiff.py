"""Port parity for the SpGEMM backward: ``maple_spgemm``'s gradients (on
the CPU, so through the plain versions of the CSR SDDMM and the dB
kernel) against ``jax.grad`` of the reference, jitted over a prebuilt
plan, at rtol = atol = 1e-5 (f32; the reference's dot and scatter-add
sum in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import CSR as RefCSR
from repro.core.sparsity import element_pattern_mask
from repro.kernels import maple_spgemm as ref_maple_spgemm
from repro.kernels.schedule import plan_spgemm as ref_plan_spgemm
from repro_torch.convert import csr_from_numpy
from repro_torch.core.csr import grow_nnz_max
from repro_torch.kernels import maple_spgemm, maple_spmspm, plan_spgemm
from repro_torch.kernels.maple_sddmm import (maple_sddmm_csr,
                                             maple_sddmm_csr_plain)
from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                              maple_spgemm_db_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ("uniform", "power_law", "banded")


def operands(kind, seed, shape=(16, 14, 18), pad=(3, 2)):
    """A and B in both packages (the reference's containers carried over
    with ``csr_from_numpy``), from the element-pattern goldens."""
    rng = np.random.default_rng(seed)
    m, k, n = shape
    out = []
    for (r, c), p in (((m, k), pad[0]), ((k, n), pad[1])):
        d = (element_pattern_mask(kind, rng, r, c)
             * rng.standard_normal((r, c))).astype(np.float32)
        ref = RefCSR.from_dense(d, nnz_max=int((d != 0).sum()) + p)
        out.append((ref, csr_from_numpy(
            np.asarray(ref.value), np.asarray(ref.col_id),
            np.asarray(ref.row_ptr), ref.shape, device="cpu")))
    return out


def ref_grads(ra, rb, loss, shared=False):
    """``jax.grad`` of ``loss(C values)`` with respect to A's and B's
    values (or to A's alone for A×A), jitted over a prebuilt plan."""
    plan = ref_plan_spgemm(ra, rb, n_lanes=3)
    mk = lambda v, r: RefCSR(v, r.col_id, r.row_ptr, r.shape)
    if shared:
        f = lambda av: loss(ref_maple_spgemm(mk(av, ra), mk(av, ra),
                                             plan=plan).value)
        return (np.asarray(jax.jit(jax.grad(f))(ra.value)),)
    f = lambda av, bv: loss(ref_maple_spgemm(mk(av, ra), mk(bv, rb),
                                             plan=plan).value)
    return tuple(np.asarray(g) for g in
                 jax.jit(jax.grad(f, argnums=(0, 1)))(ra.value, rb.value))


def port_grads(a, b, loss, schedule="balanced", shared=False):
    av = a.value.clone().requires_grad_()
    bv = av if shared else b.value.clone().requires_grad_()
    c = maple_spgemm(dataclasses.replace(a, value=av),
                     dataclasses.replace(b, value=bv), schedule=schedule,
                     n_lanes=3)
    loss(c.value).backward()
    return (av.grad,) if shared else (av.grad, bv.grad)


@pytest.mark.parametrize("schedule", ["balanced", "row_atomic", "naive"])
@pytest.mark.parametrize("kind", KINDS)
def test_grads_of_sum_sin_equal_jax_grad(kind, schedule):
    (ra, a), (rb, b) = operands(kind, seed=KINDS.index(kind))
    want = ref_grads(ra, rb, lambda v: jnp.sin(v).sum())
    got = port_grads(a, b, lambda v: torch.sin(v).sum(), schedule)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # pad slots get no gradient
    assert not got[0][a.nnz:].any() and not got[1][b.nnz:].any()


@pytest.mark.parametrize("kind", KINDS)
def test_a_times_a_shared_value_grad_equals_jax_grad(kind):
    (ra, a), _ = operands(kind, seed=10 + KINDS.index(kind),
                          shape=(15, 15, 15))
    want = ref_grads(ra, ra, lambda v: jnp.sin(v).sum(), shared=True)
    got = port_grads(a, a, lambda v: torch.sin(v).sum(), shared=True)
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_da_and_db_wrappers_equal_jax_vjp(kind):
    """The two backward wrappers alone: B6 is the VJP of a cotangent dC
    with respect to A's values, dB with respect to B's."""
    (ra, a), (rb, b) = operands(kind, seed=20 + KINDS.index(kind))
    plan = plan_spgemm(a, b, n_lanes=3)
    dc = np.random.default_rng(21).standard_normal(
        grow_nnz_max(plan.nnz_c)).astype(np.float32)
    want = ref_grads(ra, rb, lambda v: jnp.vdot(jnp.asarray(dc), v))
    dct = torch.from_numpy(dc)
    da = maple_sddmm_csr(dct, b.value, plan, n_slots=a.nnz_max)
    db = maple_spgemm_db(dct, a.value, plan, n_slots=b.nnz_max)
    np.testing.assert_allclose(da.numpy(), want[0], **TOL)
    np.testing.assert_allclose(db.numpy(), want[1], **TOL)
    assert torch.equal(da, maple_sddmm_csr_plain(dct, b.value, plan,
                                                 n_slots=a.nnz_max))
    assert torch.equal(db, maple_spgemm_db_plain(dct, a.value, plan,
                                                 n_slots=b.nnz_max))


def test_two_backward_runs_give_the_same_bits():
    (_, a), (_, b) = operands("power_law", seed=30)
    runs = [port_grads(a, b, lambda v: (v * v).sum()) for _ in range(2)]
    for g0, g1 in zip(*runs):
        assert torch.equal(g0, g1)


def test_grad_flows_only_to_what_requires_it():
    (ra, a), (rb, b) = operands("uniform", seed=31)
    av = a.value.clone().requires_grad_()
    c = maple_spgemm(dataclasses.replace(a, value=av), b)
    torch.sin(c.value).sum().backward()
    want = ref_grads(ra, rb, lambda v: jnp.sin(v).sum())
    np.testing.assert_allclose(av.grad.numpy(), want[0], **TOL)
    assert b.value.grad is None


def test_maple_spmspm_with_csr_b_is_differentiable():
    (ra, a), (rb, b) = operands("banded", seed=32)
    av = a.value.clone().requires_grad_()
    out = maple_spmspm(dataclasses.replace(a, value=av), b)
    torch.sin(out).sum().backward()
    # sum(sin(dense C)) differs from sum(sin(C values)) by sin(0) = 0 off
    # the pattern, so the gradient is the same
    want = ref_grads(ra, rb, lambda v: jnp.sin(v).sum())
    np.testing.assert_allclose(av.grad.numpy(), want[0], **TOL)
