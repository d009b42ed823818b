"""Port parity of mesh-partitioned SpMM execution: ``maple_spmm`` on a
``PartitionedSpmmPlan`` (forward, dA and dB on the CPU, through B1's and
B2's plain versions) against ``repro.kernels.maple_spmm`` on the
reference's plan for the same pattern, the reference in Pallas interpret
mode under ``jax.jit`` as its own tests run it, at rtol = atol = 1e-4;
inside the port, bit for bit: one shard equals the single-device compact
layout, and the stacked loop equals the mesh path (a bound mesh of CPU
devices); ``partition_mesh``'s answers and raises equal the reference's;
``sparse_linear``, ``SparseLogitHead.build(n_shards=4)`` (trainable and
not), ``lm.sparse_mlp_plan(n_shards=4)`` and ``plan_search`` over
``shard_counts=(1, 4)`` as the reference's.  Operands, cotangents and
weights are numpy arrays from a seed, fed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.distributed import sharding as ref_sh
from repro.kernels import autotune as ref_at
from repro.kernels import maple_spmm as ref_maple_spmm
from repro.kernels import partition as ref_part
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro_torch.core.csr import BlockCSR
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import (PartitionedSpmmPlan, autotune, maple_spmm,
                                 plan_partitioned_spmm,
                                 plan_partitioned_spmm_vjp, plan_spmm_vjp)
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import SparseLogitHead

TOL = dict(rtol=1e-4, atol=1e-4)
KINDS = ["uniform", "power_law", "banded", "empty_rows", "all_zero"]


def _pattern(rng, gm, gk, kind):
    if kind == "uniform":
        return rng.random((gm, gk)) < 0.4
    if kind == "power_law":
        mask = np.zeros((gm, gk), bool)
        for i in range(gm):
            ln = max(1, int(round(gk * (i + 1) ** -1.3)))
            mask[i, rng.choice(gk, size=ln, replace=False)] = True
        return mask
    if kind == "banded":
        return np.abs(np.subtract.outer(np.arange(gm), np.arange(gk))) <= 1
    if kind == "empty_rows":
        mask = rng.random((gm, gk)) < 0.5
        mask[::2] = False
        return mask
    return np.zeros((gm, gk), bool)


def _operands(mask, seed=0, n=24, g=None):
    rng = np.random.default_rng(seed)
    gm, gk = mask.shape
    d = rng.standard_normal((gm * 8, gk * 8)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, 8, 0), 8, 1)
    cap = max(int(mask.sum()), 1) + 2
    shape = (gk * 8, n) if g is None else (g, gk * 8, n)
    b = rng.standard_normal(shape).astype(np.float32)
    cot = rng.standard_normal(shape[:-2] + (gm * 8, n)).astype(np.float32)
    return (d, b, cot, RefBlockCSR.from_dense(d, (8, 8), n_blocks_max=cap),
            BlockCSR.from_dense(d, (8, 8), n_blocks_max=cap, device="cpu"))


def _port_grads(a, b, cot, plan):
    """(out, dA blocks, dB) of sum(maple_spmm(A, B) · cot) in the port."""
    blocks = a.blocks.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    w = BlockCSR(blocks, a.block_col, a.block_row, a.row_ptr, a.shape,
                 a.block_shape)
    out = maple_spmm(w, bt, plan=plan, bn=16)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), blocks.grad, bt.grad


def _ref_grads(ref_a, b, cot, plan):
    def loss(blocks, bb):
        w = RefBlockCSR(blocks, ref_a.block_col, ref_a.block_row,
                        ref_a.row_ptr, ref_a.shape, ref_a.block_shape)
        out = ref_maple_spmm(w, bb, plan=plan, bn=16)
        return jnp.sum(out * jnp.asarray(cot)), out
    (_, out), (da, db) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(ref_a.blocks, jnp.asarray(b))
    return out, da, db


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind,kw", [(k, dict(n_shards=3)) for k in KINDS]
                         + [("power_law", dict(n_shards=2, n_col_shards=2)),
                            ("uniform", dict(n_shards=4, device_chunk=2))])
def test_partitioned_fwd_and_grads_match_reference(kind, kw):
    mask = _pattern(np.random.default_rng(13), 10, 8, kind)
    _, b, cot, ref_a, a = _operands(mask, seed=1)
    got = _port_grads(a, b, cot, plan_partitioned_spmm_vjp(a, n_lanes=3,
                                                           **kw))
    want = _ref_grads(ref_a, b, cot, ref_part.plan_partitioned_spmm_vjp(
        ref_a, n_lanes=3, **kw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_split_row_across_shards_matches_dense():
    """A row ``device_chunk`` splits over shards merges its partials in
    the epilogue; G > 1 and ragged N."""
    mask = np.zeros((4, 16), bool)
    mask[0] = True                           # one dominant row
    mask[1:, 0] = True
    d, b, cot, _, a = _operands(mask, seed=3, n=21, g=2)
    plan = plan_partitioned_spmm_vjp(a, n_shards=4, n_lanes=2,
                                     device_chunk=4)
    assert 0 in plan.fwd.split_rows
    out, da, db = _port_grads(a, b, cot, plan)
    np.testing.assert_allclose(out.numpy(), np.einsum("mk,gkn->gmn", d, b),
                               **TOL)
    np.testing.assert_allclose(db.numpy(), np.einsum("mk,gmn->gkn", d, cot),
                               **TOL)
    full = np.einsum("gmn,gkn->mk", cot, b)
    for s in range(int(a.row_ptr[-1])):
        r, c = a.block_row[s], a.block_col[s]
        np.testing.assert_allclose(
            da[s].numpy(), full[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8], **TOL)
    assert float(da[int(a.row_ptr[-1]):].abs().max()) == 0.0   # pads


@pytest.mark.parametrize("kind", KINDS)
def test_one_shard_is_bitwise_the_compact_layout(kind):
    mask = _pattern(np.random.default_rng(17), 8, 8, kind)
    _, b, cot, _, a = _operands(mask, seed=2, g=2)
    part = plan_partitioned_spmm_vjp(a, n_shards=1, n_lanes=4)
    single = plan_spmm_vjp(a, n_lanes=4, fused="compact")
    _assert_bitwise(_port_grads(a, b, cot, part),
                    _port_grads(a, b, cot, single))


def _cpu_mesh(d, c, name="cpu"):
    if c == 1:
        return sh.Mesh([name] * d, (sh.PARTITION_AXIS,))
    return sh.Mesh([[name] * c] * d, (sh.PARTITION_AXIS, sh.COL_AXIS))


@pytest.mark.parametrize("d,c,device", [(3, 1, "cpu"), (2, 2, "cpu"),
                                        (3, 1, "cpu:0"), (2, 2, "cpu:0")])
def test_loop_equals_mesh_bitwise(d, c, device):
    """The stacked loop and the mesh path run the same kernels on the same
    operands: the same bits, forward and both gradients.  A ``"cpu:0"``
    mesh is another device than the payload's (``cpu``), so its shards
    take their own blocks, in local order."""
    mask = _pattern(np.random.default_rng(19), 10, 8, "power_law")
    _, b, cot, _, a = _operands(mask, seed=4, n=21, g=2)
    plan = plan_partitioned_spmm_vjp(a, n_shards=d, n_col_shards=c,
                                     n_lanes=3)
    mesh = _cpu_mesh(d, c, device)
    with sh.use_mesh(mesh):
        assert sh.partition_mesh(d, c)[0] is mesh
        on_mesh = _port_grads(a, b, cot, plan)
        with sh.local_partition_execution():
            assert sh.partition_mesh(d, c) == (None, None)
            loop = _port_grads(a, b, cot, plan)
    _assert_bitwise(on_mesh, loop)
    _assert_bitwise(_port_grads(a, b, cot, plan), loop)   # no mesh bound


@pytest.mark.parametrize("side", ["spmm", "sddmm"])
@pytest.mark.parametrize("mesh_device,operands", [("cuda:0", "cpu"),
                                                  ("cpu", "meta")])
def test_mesh_of_another_device_type_raises(side, mesh_device, operands):
    """A bound mesh whose devices are of another type than the operands'
    raises, forward and dA: card tensors never send a shard's work to the
    CPU, nor CPU tensors to a card (the ``meta`` tensors stand in for
    card ones here)."""
    from repro_torch.kernels import ops
    mask = _pattern(np.random.default_rng(19), 10, 8, "power_law")
    _, b, cot, _, a = _operands(mask, seed=4, n=21, g=2)
    train = plan_partitioned_spmm_vjp(a, n_shards=2, n_col_shards=2,
                                      n_lanes=3)
    b3 = torch.from_numpy(b).to(operands)
    with sh.use_mesh(_cpu_mesh(2, 2, mesh_device)), \
            pytest.raises(ValueError, match="devices of the operands' type"):
        if side == "spmm":
            ops._partitioned_spmm_f32(a.blocks.to(operands), b3, train.fwd,
                                      bn=16)
        else:
            ops._partitioned_sddmm_f32(torch.from_numpy(cot).to(operands),
                                       b3, train, bn=16)


def test_mesh_keeps_each_shards_payload_until_it_changes():
    """A mesh device that does not hold the payload takes each shard's
    own blocks once per payload version, forward and dB side: a second
    call reuses them, and after an in-place update the mesh path again
    equals the stacked loop bit for bit."""
    mask = _pattern(np.random.default_rng(19), 10, 8, "power_law")
    _, b, cot, _, a = _operands(mask, seed=4, n=21, g=2)
    plan = plan_partitioned_spmm_vjp(a, n_shards=3, n_lanes=3)
    blocks = a.blocks.clone().requires_grad_()
    w = BlockCSR(blocks, a.block_col, a.block_row, a.row_ptr, a.shape,
                 a.block_shape)
    bt = torch.from_numpy(b).requires_grad_()
    mesh_dev = torch.device("cpu:0")

    def grads():
        blocks.grad = bt.grad = None
        out = maple_spmm(w, bt, plan=plan, bn=16)
        (out * torch.from_numpy(cot)).sum().backward()
        return out.detach(), blocks.grad, bt.grad

    def kept():
        return [side.on_device(mesh_dev)["shards"][d]["payload"][blocks][1]
                for side in (plan.fwd, plan.bwd) for d in range(3)]

    with sh.use_mesh(_cpu_mesh(3, 1, "cpu:0")):
        first = grads()
        copies = kept()
        _assert_bitwise(grads(), first)
        assert all(x is y for x, y in zip(kept(), copies))
        with torch.no_grad():
            blocks.mul_(2.0)
        on_mesh = grads()
        assert not any(x is y for x, y in zip(kept(), copies))
        with sh.local_partition_execution():
            loop = grads()
    _assert_bitwise(on_mesh, loop)
    assert not torch.equal(on_mesh[0], first[0])


def test_sddmm_placement_refuses_a_pad_before_a_live_slot():
    """dA's placement takes each shard's live slots as a prefix of its
    local slots; a plan that breaks that raises instead of placing dA at
    the wrong blocks."""
    import dataclasses
    from repro_torch.kernels import ops
    mask = _pattern(np.random.default_rng(19), 10, 8, "uniform")
    _, _, _, _, a = _operands(mask, seed=4, n=21)
    train = plan_partitioned_spmm_vjp(a, n_shards=2, n_lanes=3)
    ops._sddmm_shards_on(train, torch.device("cpu"))          # a prefix
    live = train.fwd.gather_live.copy()
    assert live[0, :2].all()
    live[0, 0] = False
    bad = dataclasses.replace(
        train, fwd=dataclasses.replace(train.fwd, gather_live=live),
        _on_device={})
    with pytest.raises(ValueError, match="live slots must come first"):
        ops._sddmm_shards_on(bad, torch.device("cpu"))


def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_partition_mesh_answers_and_raises_like_the_reference():
    ref_dev = jax.local_devices()[0]

    def ref_mesh(shape, names):
        return RefMesh(np.asarray([ref_dev] * int(np.prod(shape)))
                       .reshape(shape), names)

    calls = [lambda m: m.partition_mesh(2, 0), lambda m: m.partition_mesh(4),
             lambda m: m.partition_mesh(2, 4), lambda m: m.partition_mesh(2, 2),
             lambda m: m.partition_mesh(2)]
    for shape, names in (((2, 2), ("shard", "col")), ((2,), ("shard",)),
                         ((2,), ("data",)), (None, None)):
        port = None if shape is None else sh.Mesh(
            np.full(shape, "cpu", dtype=object), names)
        ref = None if shape is None else ref_mesh(shape, names)
        with sh.use_mesh(port), ref_sh.use_mesh_rules(ref):
            for call in calls:
                msg = _raised(lambda: call(sh))
                assert msg == _raised(lambda: call(ref_sh))
                if msg is None:
                    got, want = call(sh), call(ref_sh)
                    assert got[1] == want[1]
                    assert (got[0] is port) == (want[0] is ref)
    assert sh.partition_mesh(1, 1) == ref_sh.partition_mesh(1, 1) == (None,
                                                                       None)
    # no bound mesh and no cards here: the stacked loop, where the
    # reference (one local device) falls back the same way
    assert sh.partition_mesh(2) == ref_sh.partition_mesh(2) == (None, None)


def test_maple_spmm_partitioned_arguments_like_the_reference():
    mask = _pattern(np.random.default_rng(21), 8, 8, "uniform")
    d, b, _, ref_a, a = _operands(mask, seed=5, n=40)
    got = maple_spmm(a, torch.from_numpy(b), schedule="partitioned",
                     n_shards=2, n_col_shards=2, bn=32)
    np.testing.assert_allclose(got.numpy(), d @ b, **TOL)
    one = maple_spmm(a, torch.from_numpy(b), schedule="partitioned", bn=32)
    np.testing.assert_allclose(one.numpy(), d @ b, **TOL)
    plan = plan_partitioned_spmm(a, n_shards=2, n_col_shards=2)
    ref_plan = ref_part.plan_partitioned_spmm(ref_a, n_shards=2,
                                              n_col_shards=2)
    thin = np.zeros((8, 8), bool)
    thin[np.arange(8), np.arange(8)] = True
    _, _, _, ref_thin, port_thin = _operands(thin, n=40)
    for kw, op in ((dict(plan="P", n_col_shards=4), "a"),
                   (dict(plan="P", n_shards=3), "a"),
                   (dict(plan="P"), "thin")):
        pk, rk = dict(kw), dict(kw)
        pk["plan"], rk["plan"] = plan, ref_plan
        msg = _raised(lambda: maple_spmm(port_thin if op == "thin" else a,
                                         torch.from_numpy(b), **pk))
        assert msg is not None and msg == _raised(lambda: ref_maple_spmm(
            ref_thin if op == "thin" else ref_a, jnp.asarray(b), **rk))
    with pytest.raises(ValueError, match="single-device"):
        plan_spmm_vjp(a, n_shards=2, fwd=plan_spmm_vjp(a).fwd)
    assert plan_spmm_vjp(a, n_shards=2, n_col_shards=2).fwd.n_col_shards == 2


def test_compact_kernel_fills_a_given_slot_buffer():
    """B1's ``out``: each shard's runs write their slots of one stacked
    buffer and leave the others as they were; a buffer of the wrong
    shape, type or layout is refused."""
    from repro_torch.kernels.maple_spmm import maple_spmm_compact
    mask = _pattern(np.random.default_rng(29), 10, 8, "power_law")
    _, b, _, _, a = _operands(mask, seed=8, n=5, g=2)
    plan = plan_partitioned_spmm(a, n_shards=3, n_lanes=2)
    b3 = torch.from_numpy(b)
    buf = torch.full((2, plan.n_slots * 8, 5), 7.0)
    for sd in plan.on_device(b3.device)["shards"]:
        got = maple_spmm_compact(a.blocks, sd["order"], sd["step_col"],
                                 sd["stacked_runs"], b3,
                                 n_slots=plan.n_slots, out=buf)
        assert got is buf
    view = buf.view(2, plan.n_slots, 8, 5)
    written = np.zeros(plan.n_slots, bool)
    for d, p in enumerate(plan.shards):
        written[plan.slot_offsets[d] + p.runs[:, 3]] = True
    assert bool((view[:, torch.from_numpy(~written)] == 7.0).all())
    assert not bool((view[:, torch.from_numpy(written)] == 7.0).any())
    sd = plan.on_device(b3.device)["shards"][0]
    for bad in (torch.zeros((2, plan.n_slots * 8, 4)),
                torch.zeros((2, plan.n_slots * 8, 5), dtype=torch.float64),
                torch.zeros((2, 5, plan.n_slots * 8)).transpose(1, 2)):
        with pytest.raises(ValueError, match="out must be"):
            maple_spmm_compact(a.blocks, sd["order"], sd["step_col"],
                               sd["stacked_runs"], b3,
                               n_slots=plan.n_slots, out=bad)


def _sparse_weight(d_in, d_out, density, seed):
    w = RL.init_sparse_linear(jax.random.PRNGKey(seed), d_in, d_out,
                              block_shape=(8, 8), block_density=density)
    port = BlockCSR(torch.from_numpy(np.array(w.blocks)),
                    np.asarray(w.block_col), np.asarray(w.block_row),
                    np.asarray(w.row_ptr), w.shape, w.block_shape)
    return w, port, np.asarray(w.to_dense())


def test_sparse_linear_and_head_partitioned_match_reference():
    ref_w, w, wd = _sparse_weight(32, 48, 0.4, 0)
    x = np.random.default_rng(0).standard_normal((2, 5, 32)).astype(
        np.float32)
    plan = plan_partitioned_spmm(w, n_shards=4, n_lanes=2)
    got = L.sparse_linear(w, torch.from_numpy(x), bn=16, plan=plan)
    want = RL.sparse_linear(ref_w, jnp.asarray(x), bn=16,
                            plan=ref_part.plan_partitioned_spmm(
                                ref_w, n_shards=4, n_lanes=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), x @ wd.T, **TOL)

    _, hw, hd = _sparse_weight(32, 64, 0.3, 1)
    hidden = np.random.default_rng(2).standard_normal((2, 3, 32)).astype(
        np.float32)
    head = SparseLogitHead.build(hw, n_lanes=4, n_shards=4)
    assert isinstance(head.plan, PartitionedSpmmPlan)
    assert head.predicted_cycles["plan"] >= 1.0
    np.testing.assert_allclose(head(torch.from_numpy(hidden)).numpy(),
                               hidden @ hd.T, **TOL)
    head_t = SparseLogitHead.build(hw, n_lanes=4, n_shards=4, trainable=True)
    assert isinstance(head_t.plan.bwd, PartitionedSpmmPlan)
    h = torch.from_numpy(hidden).requires_grad_()
    (head_t(h) ** 2).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(),
                               2 * (hidden @ hd.T) @ hd, **TOL)


def test_sparse_mlp_plan_partitioned_matches_reference():
    ref_w, w, _ = _sparse_weight(32, 32, 0.5, 2)
    got = lm.sparse_mlp_plan({"w_down": w}, n_lanes=2, n_shards=4)
    want = ref_lm.sparse_mlp_plan({"w_down": ref_w}, n_lanes=2, n_shards=4)
    assert isinstance(got.fwd, PartitionedSpmmPlan)
    assert isinstance(got.bwd, PartitionedSpmmPlan)
    assert got.fwd.n_shards == got.bwd.n_shards == 4
    assert got.predicted_cycles() == want.predicted_cycles()
    for side in ("fwd", "bwd"):
        for f in ("gather", "order", "slot_row"):
            assert np.array_equal(getattr(getattr(got, side), f),
                                  np.asarray(getattr(getattr(want, side), f)))


def test_plan_search_over_shards_matches_reference():
    """The surrogate search over ``shard_counts=(1, 4)`` picks the
    reference's config, and the measured rung times the reference's
    finalists (by index in the shared knob space)."""
    rng = np.random.default_rng(23)
    mask = _pattern(rng, 12, 8, "power_law")
    _, _, _, ref_a, a = _operands(mask, seed=6)
    kw = dict(shard_counts=(1, 4), budget=12, use_cache=False)
    plan, rep = autotune.plan_search(a, full=True, **kw)
    _, want = ref_at.plan_search(ref_a, full=True, **kw)
    assert rep.best_config == want.best_config
    assert (rep.n_candidates, rep.n_built, rep.best_score,
            rep.default_score) == (want.n_candidates, want.n_built,
                                   want.best_score, want.default_score)
    _, measured = autotune.plan_search(a, full=True, measure=True, top_k=3,
                                       reps=1, n_cols=8, **kw)
    _, ref_measured = ref_at.plan_search(ref_a, full=True, measure=True,
                                         top_k=3, reps=1, n_cols=8, **kw)
    assert sorted(measured.measured_us) == sorted(ref_measured.measured_us)
    with sh.use_mesh(_cpu_mesh(4, 1)):
        assert autotune._mesh_shard_counts() == (1, 4)
        assert autotune._mesh_col_shard_counts() == (1,)
    with sh.use_mesh(_cpu_mesh(2, 2)):
        assert autotune._mesh_col_shard_counts() == (2,)
