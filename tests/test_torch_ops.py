"""Port parity: ``repro_torch.kernels.ops.maple_spmm`` (on the CPU, so
through the kernels' plain versions) against ``repro.kernels.ops.maple_spmm``
in Pallas interpret mode, at rtol = atol = 1e-5 (f32; only the order of
summation differs), with 8×8 blocks and bn = 16.

Both packages run a plan in the layout it carries: read-modify-write
(``"rmw"``, the default) or compact.  The prebuilt-plan cases here build
``fused="compact"`` plans on both sides; the default (rmw) plans are held
against the reference in ``test_torch_planned.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.kernels import maple_spmm as ref_maple_spmm
from repro.kernels.schedule import plan_spmm as ref_plan_spmm
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels import (maple_spmm, maple_spmm_compact,
                                 maple_spmm_naive, plan_spmm)
from repro_torch.kernels.maple_spmm import (maple_spmm_compact_plain,
                                            maple_spmm_naive_plain)
from repro_torch.kernels.ops import _scatter_merge_f32

TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(kind, seed=0, gm=6, gk=5, extra_pad=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mask = rng.random((gm, gk)) < 0.45
    if kind == "power_law":
        mask[:] = False
        for i in range(gm):
            mask[i, rng.choice(gk, max(1, round(gk * (i + 1) ** -1.3)),
                               replace=False)] = True
    elif kind == "empty_rows":
        mask[::2] = False
    elif kind == "all_zero":
        mask[:] = False
    d = rng.standard_normal((gm * 8, gk * 8)).astype(dtype)
    d *= np.repeat(np.repeat(mask, 8, 0), 8, 1).astype(dtype)
    cap = max(int(mask.sum()), 1) + extra_pad
    return (RefBlockCSR.from_dense(d, (8, 8), n_blocks_max=cap),
            BlockCSR.from_dense(d, (8, 8), n_blocks_max=cap, device="cpu"), d)


def _rhs(seed, shape):
    return np.random.default_rng(100 + seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "power_law", "empty_rows",
                                  "all_zero"])
@pytest.mark.parametrize("schedule,kw", [
    ("naive", {}), ("balanced", {}), ("balanced", {"n_lanes": 3, "chunk": 1}),
    ("row_atomic", {"n_lanes": 3}), ("plan", {"n_lanes": 8, "chunk": 1})])
def test_maple_spmm_matches_reference_batched_ragged(kind, schedule, kw):
    ref_a, a, d = _operands(kind)
    b = _rhs(0, (3, 40, 21))                      # G = 3, ragged N = 21
    if schedule == "plan":
        want = ref_maple_spmm(ref_a, jnp.asarray(b), bn=16,
                              plan=ref_plan_spmm(ref_a, fused="compact", **kw))
        got = maple_spmm(a, torch.from_numpy(b), bn=16,
                         plan=plan_spmm(a, fused="compact", **kw))
    else:
        want = ref_maple_spmm(ref_a, jnp.asarray(b), bn=16,
                              schedule=schedule, **kw)
        got = maple_spmm(a, torch.from_numpy(b), bn=16, schedule=schedule,
                         **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), d @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("schedule", ["naive", "balanced"])
def test_maple_spmm_2d_rhs_matches_reference(schedule):
    ref_a, a, _ = _operands("uniform", seed=1)
    b = _rhs(1, (40, 7))
    want = ref_maple_spmm(ref_a, jnp.asarray(b), bn=16, schedule=schedule)
    got = maple_spmm(a, torch.from_numpy(b), bn=16, schedule=schedule)
    assert got.shape == (48, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("schedule", ["naive", "balanced"])
def test_maple_spmm_bf16_rounds_once_like_the_reference(schedule):
    ref_a, a, _ = _operands("power_law", seed=2)
    ref_bf = RefBlockCSR(ref_a.blocks.astype(jnp.bfloat16), ref_a.block_col,
                         ref_a.block_row, ref_a.row_ptr, ref_a.shape,
                         ref_a.block_shape)
    a_bf = BlockCSR(a.blocks.to(torch.bfloat16), a.block_col, a.block_row,
                    a.row_ptr, a.shape, a.block_shape)
    b = _rhs(2, (2, 40, 16))
    want = ref_maple_spmm(ref_bf, jnp.asarray(b, jnp.bfloat16), bn=16,
                          schedule=schedule, n_lanes=3, chunk=1)
    got = maple_spmm(a_bf, torch.from_numpy(b).to(torch.bfloat16), bn=16,
                     schedule=schedule, n_lanes=3, chunk=1)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want32).max()
    assert err <= 1e-2 * np.abs(want32).max()


def test_plan_mismatch_raises_like_the_reference():
    ref_a, a, _ = _operands("uniform")
    ref_o, o, _ = _operands("uniform", gm=4)
    b, b_ref = torch.zeros((40, 8)), jnp.zeros((40, 8))
    cases = [
        (dict(schedule="bogus"), "unknown schedule"),
        (dict(schedule="naive", plan="P"), "does not execute a plan"),
        (dict(reorder=True), "requires plan='auto'"),
        (dict(plan="bogus"), "unknown plan"),
        (dict(n_shards=2), "only applies"),
        (dict(plan="P", n_shards=2), "single-device"),
        (dict(plan="O"), "block-rows"),
    ]
    for kw, match in cases:
        plans = {"P": (ref_plan_spmm(ref_a), plan_spmm(a)),
                 "O": (ref_plan_spmm(ref_o), plan_spmm(o))}
        rkw, pkw = dict(kw), dict(kw)
        if kw.get("plan") in plans:
            rkw["plan"], pkw["plan"] = plans[kw["plan"]]
        with pytest.raises(ValueError, match=match):
            ref_maple_spmm(ref_a, b_ref, **rkw)
        with pytest.raises(ValueError, match=match):
            maple_spmm(a, b, **pkw)
    for fn, op, rhs in ((ref_maple_spmm, ref_a, b_ref), (maple_spmm, a, b)):
        with pytest.raises(ValueError, match="contraction"):
            fn(op, rhs[:32])
        with pytest.raises(ValueError, match=r"\(K, N\)"):
            fn(op, rhs[None, None])


def test_plan_for_another_weight_raises_like_the_reference():
    ref_a, a, _ = _operands("uniform", extra_pad=0)
    full = np.ones((48, 40), np.float32)
    ref_full = ref_plan_spmm(RefBlockCSR.from_dense(full, (8, 8)))
    plan_full = plan_spmm(BlockCSR.from_dense(full, (8, 8), device="cpu"))
    assert plan_full.order.max() >= a.n_blocks_max
    with pytest.raises(ValueError, match="capacity"):
        ref_maple_spmm(ref_a, jnp.zeros((40, 4)), plan=ref_full)
    with pytest.raises(ValueError, match="capacity"):
        maple_spmm(a, torch.zeros((40, 4)), plan=plan_full)
    d = np.ones((48, 48), np.float32)
    ref_plan16 = ref_plan_spmm(RefBlockCSR.from_dense(d, (8, 16)))
    plan16 = plan_spmm(BlockCSR.from_dense(d, (8, 16), device="cpu"))
    ref_sq, sq = (RefBlockCSR.from_dense(d, (8, 8)),
                  BlockCSR.from_dense(d, (8, 8), device="cpu"))
    with pytest.raises(ValueError, match="blocks"):
        ref_maple_spmm(ref_sq, jnp.zeros((48, 4)), plan=ref_plan16)
    with pytest.raises(ValueError, match="blocks"):
        maple_spmm(sq, torch.zeros((48, 4)), plan=plan16)


def test_unported_features_and_gradients_raise():
    _, a, _ = _operands("uniform")
    b = torch.zeros((40, 8))
    # the partitioned schedule is ported: each of these runs and equals
    # the single-device walk within f32 rounding
    rhs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (40, 8)).astype(np.float32))
    want = maple_spmm(a, rhs)
    for kw in (dict(schedule="partitioned"), dict(plan="auto", n_shards=2),
               dict(plan="auto", reorder=True, n_col_shards=2),
               dict(schedule="partitioned", n_shards=2),
               dict(schedule="partitioned", n_shards=2, n_col_shards=2)):
        torch.testing.assert_close(maple_spmm(a, rhs, **kw), want,
                                   rtol=1e-5, atol=1e-5)
    # gradients are ported: both operands get one (held against jax.grad
    # in test_torch_autodiff.py)
    b_grad = b.clone().requires_grad_()
    maple_spmm(a, b_grad).sum().backward()
    assert b_grad.grad is not None and b_grad.grad.shape == b.shape
    grad_a = BlockCSR(a.blocks.clone().requires_grad_(), a.block_col,
                      a.block_row, a.row_ptr, a.shape, a.block_shape)
    maple_spmm(grad_a, b).sum().backward()
    assert grad_a.blocks.grad.shape == a.blocks.shape


def test_wrappers_check_their_operands():
    _, a, _ = _operands("uniform")
    rp = torch.from_numpy(a.row_ptr)
    bc = torch.from_numpy(a.block_col)
    b = torch.zeros((1, 40, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        maple_spmm_naive(a.blocks.double(), rp, bc, b.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        maple_spmm_naive(a.blocks, rp, bc, b.to(torch.bfloat16))
    with pytest.raises(TypeError, match="int32"):
        maple_spmm_naive(a.blocks, rp.long(), bc, b)
    with pytest.raises(ValueError, match="contiguous"):
        maple_spmm_naive(a.blocks, rp, bc, torch.zeros((1, 4, 40)).mT)
    with pytest.raises(ValueError, match="not divisible"):
        maple_spmm_naive(a.blocks, rp, bc, torch.zeros((1, 36, 4)))
    plan = plan_spmm(a)
    with pytest.raises(ValueError, match="runs"):
        maple_spmm_compact(a.blocks, torch.from_numpy(plan.order),
                           torch.from_numpy(plan.step_col),
                           torch.from_numpy(plan.runs[:, :3].copy()), b,
                           n_slots=plan.n_lanes * plan.r_max)


def test_compact_merge_is_deterministic_and_ignores_dead_slots():
    """Idle lanes and split rows: dead slots hold NaN in the plain compact
    version, and the merge must never read them; two runs give the same
    bits."""
    _, a, d = _operands("power_law", seed=5)
    plan = plan_spmm(a, n_lanes=8, chunk=1)
    assert (plan.slot_row < 0).any()              # dead slots exist
    assert len(plan.merge_ranks) > 1              # some row is split
    b = torch.from_numpy(_rhs(5, (2, 40, 9)))
    dev = plan.on_device(b.device)
    n_slots = plan.n_lanes * plan.r_max
    tiles = maple_spmm_compact(a.blocks, dev["order"], dev["step_col"],
                               dev["runs"], b, n_slots=n_slots)
    view = tiles.view(2, n_slots, 8, 9)
    dead = torch.from_numpy(plan.slot_row.reshape(-1) < 0)
    assert torch.isnan(view[:, dead]).all()
    assert not torch.isnan(view[:, ~dead]).any()
    outs = [_scatter_merge_f32(view, dev["merge"], gm=plan.n_block_rows)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1]) and torch.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0].numpy(), d @ b.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_plain_versions_are_what_the_wrappers_run_on_cpu():
    _, a, _ = _operands("empty_rows", seed=6)
    b = torch.from_numpy(_rhs(6, (2, 40, 5)))
    rp, bc = torch.from_numpy(a.row_ptr), torch.from_numpy(a.block_col)
    before = (maple_spmm_naive.launches, maple_spmm_compact.launches)
    assert torch.equal(maple_spmm_naive(a.blocks, rp, bc, b),
                       maple_spmm_naive_plain(a.blocks, rp, bc, b))
    plan = plan_spmm(a, n_lanes=3)
    dev = plan.on_device(b.device)
    args = (a.blocks, dev["order"], dev["step_col"], dev["runs"], b)
    n_slots = plan.n_lanes * plan.r_max
    torch.testing.assert_close(maple_spmm_compact(*args, n_slots=n_slots),
                               maple_spmm_compact_plain(*args,
                                                        n_slots=n_slots),
                               rtol=0, atol=0, equal_nan=True)
    assert (maple_spmm_naive.launches, maple_spmm_compact.launches) == before
