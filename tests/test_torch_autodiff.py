"""Port parity of the SpMM backward: ``bsr_transpose_meta`` and every
array of ``plan_spmm_vjp`` exactly equal to the reference's; outputs and
both gradients of ``maple_spmm`` (on the CPU, through the kernels' plain
versions) against ``jax.grad`` of ``repro.kernels.ops.maple_spmm`` in
Pallas interpret mode, at rtol = atol = 1e-5 (f32; only the order of
summation differs).  Operands and cotangents are numpy arrays from a
seed, fed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.core.csr import bsr_transpose as ref_bsr_transpose
from repro.core.csr import bsr_transpose_meta as ref_bsr_transpose_meta
from repro.core.sparsity import block_pattern_mask
from repro.kernels import maple_spmm as ref_maple_spmm
from repro.kernels.schedule import plan_spmm_vjp as ref_plan_spmm_vjp
from repro.models.layers import sparse_linear as ref_sparse_linear
from repro.serve.engine import SparseLogitHead as RefSparseLogitHead
from repro_torch.core.csr import BlockCSR, bsr_transpose, bsr_transpose_meta
from repro_torch.kernels import (PartitionedSpmmPlan, SpmmTrainPlan,
                                 maple_spmm, plan_spmm_vjp)
from repro_torch.kernels import schedule
from repro_torch.models.layers import sparse_linear
from repro_torch.serve import SparseLogitHead

TOL = dict(rtol=1e-5, atol=1e-5)
PLAN_ARRAYS = ("order", "step_row", "step_col", "written", "step_acc",
               "flush_slot", "slot_row", "row_mask")


def _operands(kind, seed=0, gm=6, gk=5, bm=8, bk=8, extra_pad=3):
    rng = np.random.default_rng(seed)
    if kind == "empty_rows":
        mask = rng.random((gm, gk)) < 0.5
        mask[::2] = False
    elif kind == "all_zero":
        mask = np.zeros((gm, gk), bool)
    else:
        mask = block_pattern_mask(kind, rng, gm, gk)
    d = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    cap = max(int(mask.sum()), 1) + extra_pad
    return (RefBlockCSR.from_dense(d, (bm, bk), n_blocks_max=cap),
            BlockCSR.from_dense(d, (bm, bk), n_blocks_max=cap, device="cpu"),
            rng)


def _rebuild_ref(a, blocks):
    return RefBlockCSR(blocks, a.block_col, a.block_row, a.row_ptr, a.shape,
                       a.block_shape)


@pytest.mark.parametrize("kind", ["uniform", "power_law", "banded",
                                  "empty_rows", "all_zero"])
@pytest.mark.parametrize("extra_pad", [0, 4])
def test_bsr_transpose_equals_reference(kind, extra_pad):
    ref_a, a, _ = _operands(kind, seed=1, extra_pad=extra_pad)
    for pad_to in (None, a.n_blocks_max):
        want = ref_bsr_transpose_meta(ref_a, pad_to=pad_to)
        got = bsr_transpose_meta(a, pad_to=pad_to)
        for w, g in zip(want[:4], got[:4]):
            assert np.array_equal(np.asarray(w), g) and g.dtype == np.int32
        assert got[4] == want[4]
    ref_t, t = ref_bsr_transpose(ref_a), bsr_transpose(a)
    assert np.array_equal(np.asarray(ref_t.blocks), t.blocks.numpy())
    for f in ("block_col", "block_row", "row_ptr"):
        assert np.array_equal(np.asarray(getattr(ref_t, f)), getattr(t, f))
    assert (t.shape, t.block_shape) == (ref_t.shape, ref_t.block_shape)


@pytest.mark.parametrize("kind", ["uniform", "power_law", "banded",
                                  "empty_rows", "all_zero"])
@pytest.mark.parametrize("kw", [{}, {"n_lanes": 3, "chunk": 1},
                                {"n_lanes": 4, "row_atomic": True},
                                {"fused": "compact"}])
def test_plan_spmm_vjp_arrays_equal_reference(kind, kw):
    ref_a, a, _ = _operands(kind, seed=2, bk=16)
    want, got = ref_plan_spmm_vjp(ref_a, **kw), plan_spmm_vjp(a, **kw)
    for f in ("t_perm", "t_block_row", "t_block_col", "t_row_ptr",
              "block_row", "block_col"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert np.array_equal(w, g) and w.dtype == g.dtype, f
    for side in ("fwd", "bwd"):
        w, g = getattr(want, side), getattr(got, side)
        for f in PLAN_ARRAYS:
            assert np.array_equal(getattr(w, f), getattr(g, f)), (side, f)
        assert (w.r_max, w.chunk, w.fused, w.block_m, w.block_k,
                w.n_block_rows) == (g.r_max, g.chunk, g.fused, g.block_m,
                                    g.block_k, g.n_block_rows)
    assert (got.shape, got.block_shape, got.n_blocks_max) == (
        want.shape, want.block_shape, want.n_blocks_max)
    assert got.predicted_cycles() == want.predicted_cycles()
    fwd_only = plan_spmm_vjp(a, fwd=got.fwd, **{k: v for k, v in kw.items()
                                               if k != "fused"})
    assert fwd_only.fwd is got.fwd


def test_plan_spmm_vjp_refuses_partitioned_plans():
    """Shard counts above 1 route to the partitioned train plan, as in the
    reference; what it still refuses is a single-device ``fwd`` there."""
    ref_a, a, _ = _operands("uniform")
    for kw in ({"n_shards": 2}, {"n_col_shards": 2}):
        got, want = plan_spmm_vjp(a, **kw), ref_plan_spmm_vjp(ref_a, **kw)
        assert isinstance(got.fwd, PartitionedSpmmPlan)
        assert isinstance(got.bwd, PartitionedSpmmPlan)
        for side in ("fwd", "bwd"):
            g, w = getattr(got, side), getattr(want, side)
            for f in ("gather", "order", "step_col", "slot_row"):
                assert np.array_equal(getattr(g, f), np.asarray(getattr(w,
                                                                        f)))
            assert (g.n_shards, g.n_col_shards) == (w.n_shards,
                                                    w.n_col_shards)
        single = plan_spmm_vjp(a).fwd
        with pytest.raises(ValueError, match="single-device"):
            plan_spmm_vjp(a, fwd=single, **kw)
        with pytest.raises(ValueError, match="single-device"):
            ref_plan_spmm_vjp(ref_a, fwd=ref_plan_spmm_vjp(ref_a).fwd, **kw)


def _grads_both(ref_a, a, b, cot, **kw):
    """(out, dA, dB) of sum(maple_spmm(A, B) * cot) from both packages."""
    def ref_loss(blocks, bb):
        out = ref_maple_spmm(_rebuild_ref(ref_a, blocks), bb, bn=16, **kw)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out_r), (da_r, db_r) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(ref_a.blocks, jnp.asarray(b))
    blocks = a.blocks.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = maple_spmm(dataclasses.replace(a, blocks=blocks), bt, bn=16, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    return ((out.detach().numpy(), np.asarray(out_r)),
            (blocks.grad.numpy(), np.asarray(da_r)),
            (bt.grad.numpy(), np.asarray(db_r)))


@pytest.mark.parametrize("kind,extra_pad", [("uniform", 3), ("power_law", 2),
                                            ("empty_rows", 3),
                                            ("banded", 0), ("all_zero", 2)])
@pytest.mark.parametrize("schedule_kw", [
    {"schedule": "balanced"}, {"schedule": "row_atomic", "n_lanes": 3},
    {"schedule": "naive"}, {"n_lanes": 3, "chunk": 1}])
def test_maple_spmm_value_and_grads_match_jax_grad(kind, extra_pad,
                                                   schedule_kw):
    ref_a, a, rng = _operands(kind, seed=3, extra_pad=extra_pad)
    b = rng.standard_normal((3, 40, 21)).astype(np.float32)  # G=3, ragged N
    cot = rng.standard_normal((3, 48, 21)).astype(np.float32)
    for got, want in _grads_both(ref_a, a, b, cot, **schedule_kw):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_maple_spmm_grads_with_a_prebuilt_train_plan_and_2d_rhs():
    ref_a, a, rng = _operands("power_law", seed=4, bk=16)
    b = rng.standard_normal((80, 9)).astype(np.float32)
    cot = rng.standard_normal((48, 9)).astype(np.float32)
    kw = {"n_lanes": 4, "chunk": 1, "fused": "compact"}
    ref_plan = ref_plan_spmm_vjp(ref_a, **kw)
    ref = jax.grad(lambda bl, bb: jnp.sum(ref_maple_spmm(
        _rebuild_ref(ref_a, bl), bb, bn=16, plan=ref_plan) * cot),
        argnums=(0, 1))(ref_a.blocks, jnp.asarray(b))
    plan = plan_spmm_vjp(a, **kw)
    assert isinstance(plan, SpmmTrainPlan)
    blocks = a.blocks.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = maple_spmm(dataclasses.replace(a, blocks=blocks), bt, bn=16,
                     plan=plan)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(blocks.grad.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(ref[1]), **TOL)
    pads = torch.from_numpy(a.block_col < 0)
    assert (blocks.grad[pads] == 0).all()      # metadata slots stay 0


def test_backward_builds_the_train_plan_once_and_only_when_needed(
        monkeypatch):
    _, a, rng = _operands("uniform", seed=5)
    calls = []
    real = schedule.plan_spmm_vjp

    def counting(*args, **kw):
        calls.append(kw.get("fwd"))
        return real(*args, **kw)

    monkeypatch.setattr("repro_torch.kernels.ops.plan_spmm_vjp", counting)
    b = torch.from_numpy(rng.standard_normal((40, 6)).astype(np.float32))
    blocks = a.blocks.clone().requires_grad_()
    out = maple_spmm(dataclasses.replace(a, blocks=blocks), b, n_lanes=3)
    assert calls == []                          # forward only: no plan yet
    out.sum().backward()
    assert len(calls) == 1 and calls[0] is not None   # reuses the fwd plan
    with torch.no_grad():
        maple_spmm(dataclasses.replace(a, blocks=blocks), b)
    assert len(calls) == 1


def test_sparse_linear_with_a_prebuilt_train_plan_matches_reference():
    ref_a, a, rng = _operands("uniform", seed=6, gm=4, gk=6)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    cot = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ref_plan = ref_plan_spmm_vjp(ref_a)

    @jax.jit
    def ref_loss(blocks, xx):
        return jnp.sum(ref_sparse_linear(_rebuild_ref(ref_a, blocks), xx,
                                         plan=ref_plan, bn=16) * cot)

    ref = jax.grad(ref_loss, argnums=(0, 1))(ref_a.blocks, jnp.asarray(x))
    blocks = a.blocks.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = sparse_linear(dataclasses.replace(a, blocks=blocks), xt,
                      plan=plan_spmm_vjp(a))
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(blocks.grad.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref[1]), **TOL)


def test_trainable_sparse_logit_head_matches_reference():
    ref_w, w, rng = _operands("power_law", seed=7, gm=8, gk=4)
    hidden = rng.standard_normal((1, 3, 32)).astype(np.float32)
    cot = rng.standard_normal((1, 3, 64)).astype(np.float32)
    ref_head = RefSparseLogitHead.build(ref_w, trainable=True, n_lanes=4)

    def ref_loss(blocks, h):
        head = RefSparseLogitHead(weight=_rebuild_ref(ref_w, blocks),
                                  plan=ref_head.plan)
        return jnp.sum(head(h) * cot)

    ref = jax.grad(ref_loss, argnums=(0, 1))(ref_w.blocks,
                                             jnp.asarray(hidden))
    head = SparseLogitHead.build(w, trainable=True, n_lanes=4)
    assert isinstance(head.plan, SpmmTrainPlan)
    assert head.predicted_cycles == ref_head.predicted_cycles
    blocks = w.blocks.clone().requires_grad_()
    h = torch.from_numpy(hidden).requires_grad_()
    logits = SparseLogitHead(weight=dataclasses.replace(w, blocks=blocks),
                             plan=head.plan)(h)
    (logits * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(blocks.grad.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(ref[1]), **TOL)
