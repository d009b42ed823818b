"""Port parity: ``repro_torch.kernels.schedule`` against
``repro.kernels.schedule``.

Plans are host numpy, so every plan array must be exactly equal to the
reference's, and ``predicted_cycles()`` too, over the golden block
patterns × lane counts × chunk sizes × row-atomic.  The port's own
derived tables (the run table and the merge ranks) are checked against
the plan arrays they come from.
"""

import numpy as np
import pytest

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.core.maple import analyze_spgemm as ref_analyze
from repro.core.sparsity import block_pattern_mask
from repro.kernels import accum as ref_accum
from repro.kernels.schedule import plan_spmm as ref_plan_spmm
from repro_torch.core.csr import CSR, BlockCSR
from repro_torch.core.maple import analyze_spgemm
from repro_torch.kernels.accum import run_bounds
from repro_torch.kernels.schedule import bsr_stats, plan_spmm

PLAN_ARRAYS = ("order", "step_row", "step_col", "written", "step_acc",
               "flush_slot", "slot_row", "row_mask")
PATTERNS = ("uniform", "power_law", "banded", "empty_rows", "all_zero")


def _operands(kind, seed=0, gm=12, gk=10, bm=8, bk=8, extra_pad=2):
    rng = np.random.default_rng(seed)
    if kind == "empty_rows":
        mask = block_pattern_mask("uniform", rng, gm, gk)
        mask[1::3] = False
    elif kind == "all_zero":
        mask = np.zeros((gm, gk), bool)
    else:
        mask = block_pattern_mask(kind, rng, gm, gk)
    d = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    cap = max(int(mask.sum()), 1) + extra_pad
    return (RefBlockCSR.from_dense(d, (bm, bk), n_blocks_max=cap),
            BlockCSR.from_dense(d, (bm, bk), n_blocks_max=cap, device="cpu"))


def _assert_same_plan(got, ref):
    for name in PLAN_ARRAYS:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype and np.array_equal(g, r), name
    assert (got.r_max, got.chunk, got.n_rows, got.n_real_steps, got.fused,
            got.block_m, got.block_k) == \
        (ref.r_max, ref.chunk, ref.n_rows, ref.n_real_steps, ref.fused,
         ref.block_m, ref.block_k)
    assert got.predicted_cycles() == ref.predicted_cycles()
    assert got.utilization == ref.utilization


@pytest.mark.parametrize("kind", PATTERNS)
@pytest.mark.parametrize("n_lanes", [1, 3, 8])
@pytest.mark.parametrize("chunk", [None, 1, 2])
@pytest.mark.parametrize("row_atomic", [False, True])
def test_plan_spmm_arrays_equal_reference(kind, n_lanes, chunk, row_atomic):
    ref_a, a = _operands(kind)
    kw = dict(n_lanes=n_lanes, chunk=chunk, row_atomic=row_atomic)
    if row_atomic and chunk is not None:
        with pytest.raises(ValueError, match="row_atomic"):
            ref_plan_spmm(ref_a, **kw)
        with pytest.raises(ValueError, match="row_atomic"):
            plan_spmm(a, **kw)
        return
    _assert_same_plan(plan_spmm(a, **kw), ref_plan_spmm(ref_a, **kw))


@pytest.mark.parametrize("fused", ["auto", "rmw", "compact"])
def test_plan_fused_preference_is_kept(fused):
    ref_a, a = _operands("power_law", seed=3)
    _assert_same_plan(plan_spmm(a, n_lanes=4, fused=fused),
                      ref_plan_spmm(ref_a, n_lanes=4, fused=fused))


def test_plan_spmm_rejects_bad_knobs_like_the_reference():
    ref_a, a = _operands("uniform")
    for fn, op in ((ref_plan_spmm, ref_a), (plan_spmm, a)):
        with pytest.raises(ValueError):
            fn(op, n_lanes=0)
        with pytest.raises(ValueError):
            fn(op, chunk=0)
        with pytest.raises(ValueError):
            fn(op, fused="bogus")


@pytest.mark.parametrize("kind", PATTERNS)
def test_bsr_stats_equal_reference(kind):
    from repro.kernels.schedule import bsr_stats as ref_bsr_stats
    ref_a, a = _operands(kind, seed=1)
    got, ref = bsr_stats(a), ref_bsr_stats(ref_a)
    for f in ("n_rows", "n_cols", "nnz_a", "nnz_b", "partial_products",
              "nnz_c"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("a_row_len", "b_row_len", "row_partials", "row_fibers",
              "b_row_refs"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


def test_analyze_spgemm_element_csr_equals_reference():
    from repro.core.csr import CSR as RefCSR
    rng = np.random.default_rng(2)
    d = ((rng.random((9, 9)) < 0.3) * rng.standard_normal((9, 9))) \
        .astype(np.float32)
    ref_a = RefCSR.from_dense(d, nnz_max=40)
    a = CSR(value=np.asarray(ref_a.value), col_id=np.asarray(ref_a.col_id),
            row_ptr=np.asarray(ref_a.row_ptr), shape=ref_a.shape)
    got, ref = analyze_spgemm(a, a), ref_analyze(ref_a)
    assert (got.partial_products, got.nnz_c, got.nnz_a) == \
        (ref.partial_products, ref.nnz_c, ref.nnz_a)
    for f in ("row_partials", "b_row_refs", "a_row_len"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


def test_run_bounds_equals_reference_stream_walk():
    rows = np.array([0, 0, 2, 2, 2, 5, 1, 1, 1, 1], np.int32)
    steps = 5
    for base in (0, 5):
        for s in range(steps):
            want = ref_accum.run_bounds(rows, base, s, steps)
            got = run_bounds(rows, base, s, steps)
            assert [int(x) for x in got] == [int(x) for x in want]
        vec = run_bounds(rows, base, np.arange(steps), steps)
        assert [tuple(int(v) for v in col) for col in zip(*vec)] == \
            [tuple(int(v) for v in run_bounds(rows, base, s, steps))
             for s in range(steps)]


@pytest.mark.parametrize("kind", PATTERNS)
@pytest.mark.parametrize("n_lanes,chunk", [(1, None), (3, 1), (8, 2),
                                           (8, None)])
def test_run_table_and_merge_ranks_cover_every_live_slot_once(kind, n_lanes,
                                                              chunk):
    _, a = _operands(kind, seed=4)
    plan = plan_spmm(a, n_lanes=n_lanes, chunk=chunk)
    flat_rows = plan.slot_row.reshape(-1)
    live = np.nonzero(flat_rows >= 0)[0]
    # one run per live slot; its steps are one row's contiguous run
    assert sorted(plan.runs[:, 3].tolist()) == live.tolist()
    for lane, first, end, slot in plan.runs.tolist():
        assert 0 <= first < end <= plan.steps and lane == slot // plan.r_max
        rows = plan.step_row[lane, first:end]
        assert (rows == flat_rows[slot]).all()
        assert (plan.flush_slot[lane, first:end] == slot % plan.r_max).all()
        assert (first == 0 or plan.step_row[lane, first - 1] != rows[0])
    # every live step belongs to exactly one run
    covered = np.zeros(plan.order.shape, bool)
    for lane, first, end, _ in plan.runs.tolist():
        covered[lane, first:end] = True
    assert not (plan.step_col[~covered] >= 0).any()
    # merge ranks: distinct rows per rank, slot order within a row
    seen = []
    for slots, rows in plan.merge_ranks:
        assert len(set(rows.tolist())) == rows.size
        assert np.array_equal(flat_rows[slots], rows)
        seen.extend(slots.tolist())
    assert sorted(seen) == live.tolist()
    for r in set(flat_rows[live].tolist()):
        per_rank = [s[rw == r].tolist() for s, rw in plan.merge_ranks]
        slots = [x for xs in per_rank for x in xs]
        assert slots == sorted(slots)
        assert per_rank[:len(slots)] == [[x] for x in slots]


@pytest.mark.parametrize("kind", PATTERNS)
@pytest.mark.parametrize("row_atomic", [True, False])
def test_baseline_pe_cycles_equal_reference(kind, row_atomic):
    from repro.core.maple import baseline_pe_cycles as ref_baseline
    from repro.kernels.schedule import bsr_stats as ref_bsr_stats
    from repro_torch.core.maple import baseline_pe_cycles
    ref_a, a = _operands(kind, seed=3)
    for n_pes in (1, 3, 8):
        assert baseline_pe_cycles(bsr_stats(a), n_pes,
                                  row_atomic=row_atomic) == \
            ref_baseline(ref_bsr_stats(ref_a), n_pes, row_atomic=row_atomic)
