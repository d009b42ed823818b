"""Port parity: the planned read-modify-write SpMM (B4) and the default
(rmw) plans of ``maple_spmm``.

* ``maple_spmm_planned_plain`` against ``maple_spmm_planned_pallas`` in
  interpret mode over the golden patterns × ``n_lanes`` × schedules, with
  the reference wrapper's ``row_mask`` applied, within 1e-5·max + 1e-6
  (f32; only the order of summation inside a block product differs).
* ``maple_spmm`` on default plans, values and gradients, against the
  reference's default-plan call (rmw against rmw) within 1e-5.
* Within the port, rmw equals compact + the slot merge bit for bit: both
  sum a row's run PSBs in lane order, from the same PSBs.
* The ``MAPLE_VALIDATE`` gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.core.sparsity import block_pattern_mask
from repro.kernels import maple_spmm as ref_maple_spmm
from repro.kernels.maple_spmm import maple_spmm_planned_pallas
from repro.kernels.schedule import plan_spmm as ref_plan_spmm
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels import (maple_spmm, maple_spmm_compact,
                                 maple_spmm_planned, plan_spmm,
                                 plan_spmm_vjp)
from repro_torch.kernels.maple_spmm import (SEGMENTS, ffma_tile,
                                            maple_spmm_compact_plain,
                                            maple_spmm_planned_plain,
                                            ring_stages, run_layout,
                                            run_segments, walk_tile)
from repro_torch.kernels.ops import _planned_spmm_f32

GM = GK = 8
BM = BK = 8
KINDS = ("uniform", "power_law", "banded", "empty_rows", "all_zero",
         "at_capacity")
SCHEDULES = {"chunk1": dict(chunk=1), "default": dict(),
             "row_atomic": dict(row_atomic=True)}


def _operands(kind, seed=0, dtype=np.float32):
    """(reference BlockCSR, port BlockCSR, dense) of one golden pattern:
    padded capacity except ``at_capacity``."""
    rng = np.random.default_rng(seed)
    base = "uniform" if kind in ("empty_rows", "all_zero",
                                 "at_capacity") else kind
    mask = block_pattern_mask(base, rng, GM, GK)
    if kind == "empty_rows":
        mask[1] = mask[4] = mask[5] = False
    elif kind == "all_zero":
        mask[:] = False
    d = rng.standard_normal((GM * BM, GK * BK)).astype(dtype)
    d *= np.repeat(np.repeat(mask, BM, 0), BK, 1).astype(dtype)
    nnzb = int(mask.sum())
    cap = max(nnzb, 1) + (0 if kind == "at_capacity" else 3)
    return (RefBlockCSR.from_dense(d, (BM, BK), n_blocks_max=cap),
            BlockCSR.from_dense(d, (BM, BK), n_blocks_max=cap, device="cpu"),
            d)


def _rhs(seed, shape):
    return np.random.default_rng(100 + seed).standard_normal(shape) \
        .astype(np.float32)


def _planned_args(plan, blocks, b3):
    d = plan.on_device(b3.device)
    return (blocks, d["order"], d["step_col"], d["row_runs"],
            d["row_run_ptr"], b3)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("n_lanes", [1, 3, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_planned_plain_matches_pallas_interpret(kind, n_lanes, schedule):
    ref_a, a, d = _operands(kind, seed=KINDS.index(kind))
    kw = dict(SCHEDULES[schedule], n_lanes=n_lanes)
    ref_plan, plan = ref_plan_spmm(ref_a, **kw), plan_spmm(a, **kw)
    b = _rhs(n_lanes, (2, GK * BK, 16))
    want = maple_spmm_planned_pallas(
        ref_a.blocks, jnp.asarray(ref_plan.order),
        jnp.asarray(ref_plan.step_row), jnp.asarray(ref_plan.step_col),
        jnp.asarray(ref_plan.step_acc), jnp.asarray(b), m=GM * BM, bn=16,
        interpret=True)
    want = np.asarray(jnp.where(jnp.asarray(ref_plan.row_mask)[None, :, None],
                                want, 0))
    got = maple_spmm_planned_plain(*_planned_args(plan, a.blocks,
                                                  torch.from_numpy(b)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got.numpy(), np.einsum("mk,gkn->gmn", d, b),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmw_equals_compact_plus_merge_bitwise(kind, dtype):
    """On one plan the two layouts sum the same run PSBs in the same lane
    order, so they agree bit for bit (G > 1, ragged N, idle lanes, split
    rows)."""
    _, a, _ = _operands(kind, seed=20 + KINDS.index(kind))
    blocks = a.blocks.to(dtype)
    b3 = torch.from_numpy(_rhs(7, (3, GK * BK, 21))).to(dtype)
    for kw in (dict(n_lanes=8, chunk=1), dict(n_lanes=3, chunk=2),
               dict(n_lanes=8, row_atomic=True), dict(n_lanes=1)):
        rmw = plan_spmm(a, fused="rmw", **kw)
        compact = plan_spmm(a, fused="compact", **kw)
        got = _planned_spmm_f32(blocks, b3, rmw, bn=16)
        want = _planned_spmm_f32(blocks, b3, compact, bn=16)
        assert torch.equal(got, want), kw


def test_planned_wrapper_runs_the_plain_version_on_cpu_and_checks():
    _, a, _ = _operands("power_law", seed=3)
    plan = plan_spmm(a, n_lanes=3, chunk=1)
    b3 = torch.from_numpy(_rhs(3, (2, GK * BK, 5)))
    args = _planned_args(plan, a.blocks, b3)
    before = (maple_spmm_planned.launches, maple_spmm_compact.launches)
    assert torch.equal(maple_spmm_planned(*args),
                       maple_spmm_planned_plain(*args))
    assert (maple_spmm_planned.launches,
            maple_spmm_compact.launches) == before
    bad = list(args)
    bad[3] = args[3][:, :3].contiguous()
    with pytest.raises(ValueError, match="row_runs"):
        maple_spmm_planned(*bad)
    bad = list(args)
    bad[4] = args[4].long()
    with pytest.raises(TypeError, match="int32"):
        maple_spmm_planned(*bad)
    # row_runs is the run table sorted by row, lane order kept in a row
    rows = plan.slot_row.reshape(-1)[plan.row_runs[:, 3]]
    assert (np.diff(rows) >= 0).all()
    for i in range(plan.n_block_rows):
        lanes = plan.row_runs[plan.row_run_ptr[i]:plan.row_run_ptr[i + 1], 0]
        assert (np.diff(lanes) > 0).all()
    assert sorted(map(tuple, plan.row_runs)) == sorted(map(tuple, plan.runs))


def _rebuild_ref(ref_a, blocks):
    return RefBlockCSR(blocks=blocks, block_col=ref_a.block_col,
                       block_row=ref_a.block_row, row_ptr=ref_a.row_ptr,
                       shape=ref_a.shape, block_shape=ref_a.block_shape)


@pytest.mark.parametrize("kind", ["uniform", "power_law", "empty_rows"])
@pytest.mark.parametrize("schedule,kw", [
    ("balanced", {}), ("balanced", {"n_lanes": 3, "chunk": 1}),
    ("row_atomic", {"n_lanes": 3}), ("train_plan", {"n_lanes": 8,
                                                    "chunk": 1})])
def test_default_rmw_plans_match_reference_values_and_grads(kind, schedule,
                                                            kw):
    ref_a, a, d = _operands(kind, seed=40 + KINDS.index(kind))
    b = _rhs(4, (2, GK * BK, 9))
    cot = _rhs(5, (2, GM * BM, 9))
    if schedule == "train_plan":
        ref_kw = dict(plan=ref_plan_spmm(ref_a, **kw))
        train = plan_spmm_vjp(a, **kw)
        assert (train.fwd.fused, train.bwd.fused) == ("rmw", "rmw")
        port_kw = dict(plan=train)
    else:
        ref_kw = port_kw = dict(schedule=schedule, **kw)

    def ref_loss(blocks, bb):
        out = ref_maple_spmm(_rebuild_ref(ref_a, blocks), bb, bn=16,
                             **ref_kw)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), (da_ref, db_ref) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(ref_a.blocks, jnp.asarray(b))
    blocks = a.blocks.clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    from dataclasses import replace
    out = maple_spmm(replace(a, blocks=blocks), bt, bn=16, **port_kw)
    (out * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(blocks.grad.numpy(), np.asarray(da_ref), **tol)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_ref), **tol)


def test_validate_gate_raises_on_a_broken_pad_contract(monkeypatch):
    ref_a, a, _ = _operands("uniform", seed=9)
    nnzb = a.nnzb
    a.blocks[nnzb] = 1.0                          # a non-zero pad block
    ref_broken = _rebuild_ref(ref_a, ref_a.blocks.at[nnzb].set(1.0))
    b = torch.zeros((GK * BK, 4))
    monkeypatch.delenv("MAPLE_VALIDATE", raising=False)
    maple_spmm(a, b)                              # the gate is off
    monkeypatch.setenv("MAPLE_VALIDATE", "1")
    with pytest.raises(ValueError, match="pad blocks must be 0"):
        ref_maple_spmm(ref_broken, jnp.zeros((GK * BK, 4)))
    with pytest.raises(ValueError, match="pad blocks must be 0"):
        maple_spmm(a, b)
    monkeypatch.setenv("MAPLE_VALIDATE", "0")
    maple_spmm(a, b)


# --------------------------------------------------------------------------
# the host's half of the run walk B1 and B4 share on the card
# --------------------------------------------------------------------------

def _split_plan(dtype=torch.float32, n_lanes=12):
    """A power-law pattern whose heavy rows the plan splits over more
    lanes than a cluster has blocks."""
    rng = np.random.default_rng(61)
    mask = block_pattern_mask("power_law", rng, 6, 24)
    mask[0] = True
    d = rng.standard_normal((6 * BM, 24 * BK)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, BM, 0), BK, 1)
    a = BlockCSR.from_dense(d, (BM, BK), device="cpu")
    blocks = a.blocks.to(dtype)
    return a, blocks, plan_spmm(a, n_lanes=n_lanes, chunk=1)


@pytest.mark.parametrize("n_lanes", [9, 12, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmw_equals_compact_plus_merge_on_rows_over_a_cluster(n_lanes,
                                                              dtype):
    """Rows split into more runs than a cluster has blocks (9 or more
    lanes, power-law rows): the plain versions still agree bit for bit."""
    a, blocks, plan = _split_plan(dtype, n_lanes)
    assert np.diff(plan.row_run_ptr).max() >= 9 > SEGMENTS
    b3 = torch.from_numpy(_rhs(8, (2, a.shape[1], 17))).to(dtype)
    rmw = _planned_spmm_f32(blocks, b3, plan, bn=128)
    compact = _planned_spmm_f32(
        blocks, b3, plan_spmm(a, n_lanes=n_lanes, chunk=1,
                              fused="compact"), bn=128)
    assert torch.equal(rmw, compact)


@pytest.mark.parametrize("first,end", [(0, 0), (3, 4), (0, 3), (5, 12),
                                       (2, 154)])
def test_run_segments_cover_the_run_in_order(first, end):
    segs = run_segments(first, end)
    assert len(segs) == SEGMENTS
    assert segs[0][0] == first and segs[-1][1] == end
    assert all(lo <= hi for lo, hi in segs)
    assert all(segs[j][1] == segs[j + 1][0] for j in range(SEGMENTS - 1))
    sizes = [hi - lo for lo, hi in segs]
    assert max(sizes) - min(sizes) <= 1


def test_segment_tree_sums_the_plain_psbs():
    """The kernels' tree — four segment chains, ``(p0 + p1) + (p2 + p3)`` —
    over every run of a split plan is the plain PSB within f32 rounding,
    and each live step lands in exactly one segment."""
    a, blocks, plan = _split_plan()
    b3 = torch.from_numpy(_rhs(9, (1, a.shape[1], 5)))
    n_slots = plan.n_lanes * plan.r_max
    d = plan.on_device(b3.device)
    want = maple_spmm_compact_plain(blocks, d["order"], d["step_col"],
                                    d["runs"], b3, n_slots=n_slots)
    want = want.view(1, n_slots, BM, 5)
    panels = b3[0].reshape(a.shape[1] // BK, BK, 5)
    steps = plan.order.shape[1]
    for lane, first, end, slot in plan.runs.tolist():
        parts, seen = [], 0
        for lo, hi in run_segments(first, end):
            p = torch.zeros(BM, 5)
            for s in range(lo, hi):
                col = int(plan.step_col.reshape(-1)[lane * steps + s])
                if col >= 0:
                    blk = int(plan.order.reshape(-1)[lane * steps + s])
                    p = p + blocks[blk] @ panels[col]
                    seen += 1
            parts.append(p)
        live = int((plan.step_col[lane, first:end] >= 0).sum())
        assert seen == live
        tree = (parts[0] + parts[1]) + (parts[2] + parts[3])
        torch.testing.assert_close(tree, want[0, slot], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("bm,tile,want", [
    (64, 128, (8, 8)), (64, 64, (4, 8)), (64, 32, (4, 4)), (64, 16, (2, 4)),
    (16, 64, (2, 4)), (8, 16, (1, 1)), (8, 32, (1, 2)), (128, 128, None)])
def test_ffma_tile_uses_the_most_consumer_threads(bm, tile, want):
    assert ffma_tile(bm, tile) == want
    if want is not None:
        assert (bm // want[0]) * (tile // want[1]) <= 128


@pytest.mark.parametrize("dtype,n,block,bn,want", [
    (torch.float32, 1, (64, 64), 128, ("skinny", 4, 1, 512)),
    (torch.float32, 4, (64, 64), 128, ("skinny", 4, 1, 512)),
    (torch.float32, 17, (64, 64), 128, ("ffma", 32, 1, 2048)),
    (torch.float32, 256, (64, 64), 128, ("ffma", 128, 2, 8192)),
    (torch.float32, 256, (64, 64), 256, ("ffma", 128, 2, 8192)),
    (torch.bfloat16, 1, (64, 64), 128, ("wgmma", 8, 1, 512)),
    (torch.bfloat16, 17, (64, 64), 128, ("wgmma", 64, 1, 4096)),
    (torch.bfloat16, 256, (64, 64), 128, ("wgmma", 128, 2, 8192)),
    (torch.bfloat16, 21, (8, 8), 16, ("ffma", 16, 2, 128)),
    (torch.float32, 70, (16, 32), 64, ("ffma", 64, 2, 1024))])
def test_run_layout_tiles_and_scratch(dtype, n, block, bn, want):
    """The consumer, N tile, tile count and partial size of a launch; B4's
    scratch is G · n_tiles · n_runs · frag floats."""
    lay = run_layout(dtype, n, *block, bn)
    assert (lay["consumer"], lay["tile"], lay["n_tiles"],
            lay["frag"]) == want
    assert lay["n_tiles"] * lay["tile"] >= n


@pytest.mark.parametrize("dtype,n,bn,runs,g,want", [
    (torch.float32, 256, 128, 41, 1, 64),     # the MLP's forward plan
    (torch.float32, 256, 128, 152, 1, 128),   # its transpose-side plan
    (torch.float32, 128, 128, 41, 1, 32),
    (torch.float32, 1, 128, 2400, 1, 16),     # the head at decode
    (torch.float32, 256, 128, 1, 1, 32),      # floor of the FFMA tile
    (torch.bfloat16, 256, 128, 41, 1, 64),
    (torch.bfloat16, 256, 128, 1, 4, 64),     # floor of wgmma
    (torch.float32, 256, 256, 2400, 4, 128)])
def test_walk_tile_narrows_until_the_grid_fills_the_card(dtype, n, bn, runs,
                                                         g, want):
    tile = walk_tile(dtype, n, 64, 64, bn, runs=runs, g=g, sms=132)
    assert tile == want
    if tile < min(bn, 128, 1 << max(n - 1, 0).bit_length()):
        assert runs * SEGMENTS * g * -(-n // (2 * tile)) < 4 * 132


@pytest.mark.parametrize("lanes,steps,runs,want", [
    (8, 195, 41, 2),       # the MLP's forward plan: 9.5 steps a segment
    (8, 190, 152, 2),      # its transpose-side plan: 2.5
    (8, 6000, 2400, 2),    # the head at decode: 5
    (8, 6000, 40, 4),      # the head's transpose-side plan: 300
    (1, 65, 1, 4), (1, 64, 1, 2), (4, 10, 0, 2)])
def test_ring_stages_follow_the_segment_length(lanes, steps, runs, want):
    assert ring_stages(lanes * steps, runs) == want
