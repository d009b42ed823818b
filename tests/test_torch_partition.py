"""Port parity of mesh-partitioned SpMM planning
(``repro_torch.kernels.partition``) against ``repro.kernels.partition``:
every array of ``PartitionedSpmmPlan`` — each shard's ``SpmmPlan``
included — and every derived number (``split_rows``, ``shard_steps``,
``padding_waste``, ``predicted_cycles``, ``dense_operand_bytes``) exactly
equal to the reference's on the golden patterns; the padding-aware
repack on the reference's skewed fixture; the partitioned transpose side
of ``plan_partitioned_spmm_vjp``; ``sddmm_shard_meta``; the validation
errors.  Host numpy only: nothing here runs a kernel."""

import dataclasses

import numpy as np
import pytest

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.kernels import partition as ref_part
from repro.kernels.maple_sddmm import sddmm_shard_meta as ref_shard_meta
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels import partition as part
from repro_torch.kernels import plan_spmm
from repro_torch.kernels.maple_sddmm import sddmm_shard_meta

KINDS = ["uniform", "power_law", "banded", "empty_rows", "all_zero"]
STACKED = ("gather", "gather_live", "order", "step_row", "step_col",
           "flush_slot", "slot_row", "row_shard")
SHARD = ("order", "step_row", "step_col", "written", "step_acc",
         "flush_slot", "slot_row", "row_mask")
SCALARS = ("split_rows", "r_max", "n_block_rows", "block_m", "block_k",
           "n_col_shards", "shard_steps", "shard_r_max", "fused",
           "n_shards", "n_lanes", "steps", "slot_cap", "padding_waste")


def _pattern(rng, gm, gk, kind):
    # the reference partition tests' fixtures
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


def _both(mask, bm=8, bk=8, extra_pad=2, seed=0):
    gm, gk = mask.shape
    d = np.random.default_rng(seed).standard_normal(
        (gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    cap = max(int(mask.sum()), 1) + extra_pad
    return (RefBlockCSR.from_dense(d, (bm, bk), n_blocks_max=cap),
            BlockCSR.from_dense(d, (bm, bk), n_blocks_max=cap, device="cpu"))


def _pareto(seed, gm=20, gk=16, b=4):
    """The reference's skewed fixture (``tests/test_partitioned_2d.py``)."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(np.maximum(
        (rng.pareto(1.0, gm) * 2).astype(int) + 1, 1), gk)
    mask = np.zeros((gm, gk), bool)
    for i, ln in enumerate(lens):
        mask[i, rng.choice(gk, size=ln, replace=False)] = True
    return _both(mask, bm=b, bk=b, extra_pad=0, seed=seed)


def assert_plan_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in STACKED:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    for f in SCALARS:
        assert getattr(got, f) == getattr(want, f), f
    for f in dataclasses.fields(want.stats):
        assert np.array_equal(np.asarray(getattr(got.stats, f.name)),
                              np.asarray(getattr(want.stats, f.name))), f
    assert got.predicted_cycles() == want.predicted_cycles()
    assert got.per_shard_cycles() == want.per_shard_cycles()
    for n in (1, 37, 256):
        assert got.dense_operand_bytes(n, g=2) == \
            want.dense_operand_bytes(n, g=2)
    assert len(got.shards) == len(want.shards)
    for gs, ws in zip(got.shards, want.shards):
        for f in SHARD:
            assert np.array_equal(getattr(gs, f),
                                  np.asarray(getattr(ws, f))), f
        assert (gs.r_max, gs.chunk, gs.fused, gs.n_real_steps) == (
            ws.r_max, ws.chunk, ws.fused, ws.n_real_steps)
        assert gs.predicted_cycles() == ws.predicted_cycles()


CASES = [dict(n_shards=d, n_col_shards=c) for d in (1, 3, 8) for c in (1, 2)]
CASES += [dict(n_shards=3, device_chunk=2), dict(n_shards=4, device_chunk=1,
                                                 n_lanes=3),
          dict(n_shards=3, n_lanes=2, chunk=1), dict(n_shards=3,
                                                     row_atomic=True),
          dict(n_shards=8, repack=False)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_partitioned_plan_equals_reference(kind, kw):
    ref_a, a = _both(_pattern(np.random.default_rng(7), 12, 10, kind))
    kw = dict({"n_lanes": 4}, **kw)
    assert_plan_equal(part.plan_partitioned_spmm(a, **kw),
                      ref_part.plan_partitioned_spmm(ref_a, **kw))


@pytest.mark.parametrize("kind", ["uniform", "power_law", "banded"])
def test_column_split_leaves_the_plan_unchanged(kind):
    """A plan at C > 1 is the 1-D plan: every array equal, only
    ``n_col_shards`` differs (the reference's
    ``test_c1_plan_and_execution_bit_identical_to_1d``)."""
    from repro_torch.kernels.autotune import _plans_bit_identical
    _, a = _both(_pattern(np.random.default_rng(5), 12, 10, kind))
    p1d = part.plan_partitioned_spmm(a, n_shards=4, n_lanes=3)
    p2d = part.plan_partitioned_spmm(a, n_shards=4, n_lanes=3,
                                     n_col_shards=2)
    assert (p1d.n_col_shards, p2d.n_col_shards) == (1, 2)
    assert not _plans_bit_identical(p1d, p2d)        # the column split
    assert _plans_bit_identical(p1d, dataclasses.replace(p2d,
                                                         n_col_shards=1))
    for f in STACKED:
        assert np.array_equal(getattr(p1d, f), getattr(p2d, f))
    assert p1d.merge_ranks is not p2d.merge_ranks
    for (s1, r1), (s2, r2) in zip(p1d.merge_ranks, p2d.merge_ranks):
        assert np.array_equal(s1, s2) and np.array_equal(r1, r2)


def test_split_rows_cross_devices_like_the_reference():
    mask = np.zeros((4, 16), bool)
    mask[0] = True                        # one dominant row
    mask[1:, 0] = True
    ref_a, a = _both(mask)
    got = part.plan_partitioned_spmm(a, n_shards=4, n_lanes=2,
                                     device_chunk=4)
    assert_plan_equal(got, ref_part.plan_partitioned_spmm(
        ref_a, n_shards=4, n_lanes=2, device_chunk=4))
    assert 0 in got.split_rows
    assert sum(bool(s.written.any(axis=0)[0]) for s in got.shards) > 1


@pytest.mark.parametrize("seed", [6, 1])
def test_repack_equals_reference_on_the_skewed_fixture(seed):
    ref_a, a = _pareto(seed)
    for repack in (False, True):
        assert_plan_equal(
            part.plan_partitioned_spmm(a, n_shards=4, n_lanes=4,
                                       repack=repack),
            ref_part.plan_partitioned_spmm(ref_a, n_shards=4, n_lanes=4,
                                           repack=repack))
    # the items _repack_devices returns, from the same count-LPT start
    rptr = a.row_ptr.astype(np.int64)
    items = [(i, int(rptr[i]), int(rptr[i + 1])) for i in range(20)
             if rptr[i + 1] > rptr[i]]
    items.sort(key=lambda c: (-(c[2] - c[1]), c[0], c[1]))
    start, _ = part._lpt_pack([(c[2] - c[1], c) for c in items], 4)
    kw = dict(n_lanes=4, chunk=None, row_atomic=False)
    got = part._repack_devices([list(d) for d in start], **kw)
    want = ref_part._repack_devices([list(d) for d in start], **kw)
    assert got == want
    for dev in got:
        counts = {}
        for row, lo, hi in dev:
            counts[row] = counts.get(row, 0) + hi - lo
        assert part._planned_steps(counts, 4, None, False) == \
            ref_part._planned_steps(counts, 4, None, False)
    if seed == 6:                          # the reference's pinned case
        p0 = part.plan_partitioned_spmm(a, n_shards=4, n_lanes=4,
                                        repack=False)
        p1 = part.plan_partitioned_spmm(a, n_shards=4, n_lanes=4)
        assert p1.steps < p0.steps and p1.padding_waste == 0.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kw", [dict(n_shards=3), dict(n_shards=2,
                                                       n_col_shards=2),
                                dict(n_shards=4, device_chunk=1)])
def test_partitioned_vjp_and_shard_meta_equal_reference(kind, kw):
    ref_a, a = _both(_pattern(np.random.default_rng(11), 10, 12, kind))
    got = part.plan_partitioned_spmm_vjp(a, n_lanes=3, **kw)
    want = ref_part.plan_partitioned_spmm_vjp(ref_a, n_lanes=3, **kw)
    assert_plan_equal(got.fwd, want.fwd)
    assert_plan_equal(got.bwd, want.bwd)
    for f in ("t_perm", "t_block_row", "t_block_col", "t_row_ptr",
              "block_row", "block_col"):
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f)))
    assert got.predicted_cycles() == want.predicted_cycles()
    meta = sddmm_shard_meta(got.fwd.gather, got.fwd.gather_live,
                            got.block_row, got.block_col)
    ref_meta = ref_shard_meta(want.fwd.gather, want.fwd.gather_live,
                              want.block_row, want.block_col)
    for g, w in zip(meta, ref_meta):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # a prebuilt forward rides along unchanged
    again = part.plan_partitioned_spmm_vjp(a, n_lanes=3, fwd=got.fwd, **kw)
    assert again.fwd is got.fwd


def test_merge_ranks_cover_every_live_slot_once():
    """The port's epilogue order: each live slot of the stacked buffer
    appears once, at the rank of its row's count so far in stacked
    ``(shard, lane, slot)`` order, and names its row; one shard is the
    shard plan's merge order."""
    _, a = _both(_pattern(np.random.default_rng(3), 12, 10, "power_law"))
    plan = part.plan_partitioned_spmm(a, n_shards=3, n_lanes=2,
                                      device_chunk=2)
    off = plan.slot_offsets
    assert off[-1] == plan.n_slots == sum(p.n_lanes * p.r_max
                                          for p in plan.shards)
    stacked_rows = np.concatenate([p.slot_row.reshape(-1)
                                   for p in plan.shards])
    seen, order = {}, []
    for k, (slots, rows) in enumerate(plan.merge_ranks):
        assert rows.size == np.unique(rows).size
        assert np.array_equal(stacked_rows[slots], rows)
        for s, r in zip(slots.tolist(), rows.tolist()):
            assert seen.get(r, 0) == k
            seen[r] = k + 1
            order.append((r, k, s))
    assert sum(seen.values()) == int((stacked_rows >= 0).sum())
    for r in seen:                  # a row's slots in stacked order
        mine = sorted((k, s) for rr, k, s in order if rr == r)
        assert [s for _, s in mine] == sorted(s for _, s in mine)
    one = part.plan_partitioned_spmm(a, n_shards=1, n_lanes=2)
    single = plan_spmm(a, n_lanes=2, fused="compact")
    assert len(one.merge_ranks) == len(single.merge_ranks)
    for (s1, r1), (s0, r0) in zip(one.merge_ranks, single.merge_ranks):
        assert np.array_equal(s1, s0) and np.array_equal(r1, r0)


def test_validation_errors_equal_reference():
    ref_a, a = _both(_pattern(np.random.default_rng(0), 4, 4, "uniform"))
    for kw, match in ((dict(n_shards=0), "n_shards"),
                      (dict(n_shards=2, n_col_shards=0), "n_col_shards"),
                      (dict(n_shards=2, device_chunk=0), "device_chunk")):
        with pytest.raises(ValueError, match=match) as got:
            part.plan_partitioned_spmm(a, **kw)
        with pytest.raises(ValueError, match=match) as want:
            ref_part.plan_partitioned_spmm(ref_a, **kw)
        assert str(got.value) == str(want.value)
    fwd = part.plan_partitioned_spmm(a, n_shards=2, n_col_shards=2)
    ref_fwd = ref_part.plan_partitioned_spmm(ref_a, n_shards=2,
                                             n_col_shards=2)
    with pytest.raises(ValueError, match="column panels") as got:
        part.plan_partitioned_spmm_vjp(a, n_shards=2, n_col_shards=4,
                                       fwd=fwd)
    with pytest.raises(ValueError, match="column panels") as want:
        ref_part.plan_partitioned_spmm_vjp(ref_a, n_shards=2,
                                           n_col_shards=4, fwd=ref_fwd)
    assert str(got.value) == str(want.value)
