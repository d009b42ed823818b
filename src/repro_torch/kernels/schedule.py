"""Load-balanced execution planning for the Maple kernels (port of
``repro.kernels.schedule``): SpMM forward plans, the training plan that
adds the transpose-side schedule for the backward, and the SpGEMM's
symbolic phase (:func:`plan_spgemm`).

Plans are host numpy over the sparsity pattern and come out identical to
the reference's: ``order``, ``step_row``, ``step_col``, ``written``,
``step_acc``, ``flush_slot``, ``slot_row``, ``r_max`` and ``row_mask`` are
held against it with ``np.array_equal``, and ``predicted_cycles()`` with
``==``; so are every array of :class:`SpgemmPlan`.  The port adds the
derived tables the Hopper executors need (``SpmmPlan.runs`` and
``merge_ranks``; ``SpgemmPlan.on_device``), built once per plan.
Partitioned (multi-device) plans are not ported yet.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch

from repro_torch.core.csr import (CSR, BlockCSR, bsr_transpose_meta,
                                  spgemm_row_upper_bounds, transpose_perm)
from repro_torch.core.formats import as_element_csr, ell_slots
from repro_torch.core.maple import (SpGEMMStats, analyze_spgemm,
                                    baseline_pe_cycles, expand_partials,
                                    maple_pe_cycles)
from repro_torch.kernels.accum import run_bounds

_T = TypeVar("_T")


def bsr_stats(a: BlockCSR) -> SpGEMMStats:
    """Block-granular workload statistics: the block pattern analyzed
    against an identity B, so ``row_partials[i]`` = non-zero blocks in
    block-row i and ``partial_products`` = total non-zero blocks."""
    gm, gk = a.n_block_rows, a.n_block_cols
    rptr = np.asarray(a.row_ptr).astype(np.int32)
    nnzb = int(rptr[-1])
    cols = np.asarray(a.block_col).astype(np.int32)[:max(nnzb, 1)]
    pattern = CSR(value=torch.zeros(max(nnzb, 1)),
                  col_id=cols, row_ptr=rptr, shape=(gm, gk))
    eye = CSR(value=torch.ones(gk),
              col_id=np.arange(gk, dtype=np.int32),
              row_ptr=np.arange(gk + 1, dtype=np.int32), shape=(gk, gk))
    return analyze_spgemm(pattern, eye)


def _lpt_pack(weighted: Sequence[Tuple[int, _T]],
              n_lanes: int) -> Tuple[List[List[_T]], np.ndarray]:
    """LPT greedy: pre-sorted ``(weight, item)`` onto the least-loaded
    lane; ties resolve to the lowest lane index."""
    heap = [(0, l) for l in range(n_lanes)]  # already heap-ordered
    lanes: List[List[_T]] = [[] for _ in range(n_lanes)]
    loads = np.zeros(n_lanes, np.int64)
    for w, item in weighted:
        load, l = heapq.heappop(heap)
        lanes[l].append(item)
        loads[l] += int(w)
        heapq.heappush(heap, (load + int(w), l))
    return lanes, loads


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A static lane schedule: per lane ``l`` / step ``s``, ``order`` (the
    block to consume), ``step_row`` (output row), ``step_col`` (B panel,
    -1 on pad steps) and ``written[l, r]`` (lane l flushes row r)."""

    order: np.ndarray      # (n_lanes, steps) int32
    step_row: np.ndarray   # (n_lanes, steps) int32
    step_col: np.ndarray   # (n_lanes, steps) int32, -1 on pads
    written: np.ndarray    # (n_lanes, n_rows) bool
    chunk: int             # max slots per row-chunk (0 = rows atomic)
    n_rows: int
    n_real_steps: int      # live steps scheduled
    stats: SpGEMMStats

    @property
    def n_lanes(self) -> int:
        return self.order.shape[0]

    @property
    def steps(self) -> int:
        return self.order.shape[1]

    @property
    def utilization(self) -> float:
        return self.n_real_steps / max(self.n_lanes * self.steps, 1)

    def _realized_makespan(self) -> float:
        """What the grid executes, in the plan's work unit."""
        return float(self.steps)

    def predicted_cycles(self) -> Dict[str, float]:
        """``plan`` (realized makespan), ``maple`` (m = n_lanes Maple PE)
        and ``row_atomic`` (MatRaptor bound), priced by the shared model."""
        return {
            "plan": self._realized_makespan(),
            "maple": maple_pe_cycles(self.stats, macs_per_pe=self.n_lanes,
                                     n_pes=1),
            "row_atomic": baseline_pe_cycles(self.stats, n_pes=self.n_lanes),
        }


class SpmmPlan(ExecutionPlan):
    """Block-granular plan for ``maple_spmm`` over one BlockCSR operand.

    Derived exactly as in the reference: ``step_acc`` (1 where a flush
    accumulates), the compact layout's ``flush_slot`` / ``slot_row``
    (lane l flushes its t-th distinct row into slot t; ``-1`` marks dead
    slots), ``r_max`` and the element-granular ``row_mask``.  ``fused`` is
    the reference's layout preference, kept so the arrays match; the port
    always executes the compact layout.

    Derived for the Hopper executor, once per plan:

    * ``runs`` — ``(n_runs, 4)`` int32 rows ``(lane, first step, end step,
      flat slot)``, one per (lane, row) PSB run that flushes a live slot
      (``flat slot = lane · r_max + slot``).  The planned kernel launches
      one thread block per run; idle lanes, whose only run drains pad
      steps into a dead slot, get none, so dead slots are never written.
    * ``merge_ranks`` — the deterministic slot merge: a list over rank
      ``k`` of ``(flat slots, rows)`` where each row's k-th live slot (in
      slot order) appears in rank k.  Rows within a rank are distinct.
    """

    def __init__(self, *, order: np.ndarray, step_row: np.ndarray,
                 step_col: np.ndarray, written: np.ndarray, chunk: int,
                 n_block_rows: int, n_real_steps: int, stats: SpGEMMStats,
                 block_m: int, block_k: int, fused: str = "rmw"):
        super().__init__(order=order, step_row=step_row, step_col=step_col,
                         written=written, chunk=chunk, n_rows=n_block_rows,
                         n_real_steps=n_real_steps, stats=stats)
        if fused not in ("rmw", "compact"):
            raise ValueError(f"unknown fused mode {fused!r}")
        n_lanes = order.shape[0]
        gm = n_block_rows
        rows = np.clip(step_row, 0, max(gm - 1, 0))
        any_writer = written.any(axis=0) if gm else np.zeros(0, bool)
        first_lane = np.where(any_writer, written.argmax(axis=0), -1)
        lane_idx = np.arange(n_lanes, dtype=np.int64)[:, None]
        if gm:
            owns = np.take_along_axis(written, rows, axis=1)
            is_init = owns & (first_lane[rows] == lane_idx)
        else:
            is_init = np.zeros(step_row.shape, bool)
        step_acc = (~is_init).astype(np.int32)
        r_max = max(int(written.sum(axis=1).max(initial=0)), 1)
        slot_of = np.zeros((n_lanes, max(gm, 1)), np.int32)
        slot_row = np.full((n_lanes, r_max), -1, np.int32)
        for l in range(n_lanes):
            rows_l = np.nonzero(written[l])[0]
            slot_of[l, rows_l] = np.arange(rows_l.size, dtype=np.int32)
            slot_row[l, :rows_l.size] = rows_l
        flush_slot = (np.take_along_axis(slot_of, rows, axis=1)
                      if gm else np.zeros(step_row.shape, np.int32))
        object.__setattr__(self, "fused", fused)
        object.__setattr__(self, "block_m", int(block_m))
        object.__setattr__(self, "block_k", int(block_k))
        object.__setattr__(self, "step_acc", step_acc)
        object.__setattr__(self, "flush_slot", flush_slot.astype(np.int32))
        object.__setattr__(self, "slot_row", slot_row)
        object.__setattr__(self, "r_max", r_max)
        object.__setattr__(self, "row_mask", np.repeat(any_writer, block_m))
        object.__setattr__(self, "runs", self._run_table())
        object.__setattr__(self, "merge_ranks", self._merge_ranks())
        object.__setattr__(self, "_on_device", {})

    @property
    def n_block_rows(self) -> int:
        return self.n_rows

    def _run_table(self) -> np.ndarray:
        n_lanes, steps = self.order.shape
        flat_row = self.step_row.reshape(-1)
        s = np.arange(steps)
        out = []
        for l in range(n_lanes):
            _, first, last = run_bounds(flat_row, l * steps, s, steps)
            starts = np.nonzero(first)[0]
            ends = np.nonzero(last)[0] + 1
            slots = self.flush_slot[l, starts]
            live = self.slot_row[l, slots] >= 0
            out.append(np.stack([np.full(int(live.sum()), l), starts[live],
                                 ends[live], l * self.r_max + slots[live]],
                                axis=1))
        return np.concatenate(out).astype(np.int32).reshape(-1, 4)

    def _merge_ranks(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        flat_rows = self.slot_row.reshape(-1)
        live = np.nonzero(flat_rows >= 0)[0]          # slot order
        rows = flat_rows[live]
        rank = np.zeros(live.size, np.int64)
        seen: Dict[int, int] = {}
        for i, r in enumerate(rows.tolist()):
            rank[i] = seen.get(r, 0)
            seen[r] = rank[i] + 1
        return [(live[rank == k].astype(np.int64),
                 rows[rank == k].astype(np.int64))
                for k in range(int(rank.max(initial=-1)) + 1)]

    def on_device(self, device: torch.device) -> dict:
        """The executor's plan tensors on ``device``, copied once per
        device and cached on the plan."""
        key = str(device)
        cached = self._on_device.get(key)
        if cached is None:
            as_t = lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).to(device)
            cached = {
                "order": as_t(self.order),
                "step_col": as_t(self.step_col),
                "runs": as_t(self.runs),
                "merge": [(as_t(s), as_t(r)) for s, r in self.merge_ranks],
            }
            self._on_device[key] = cached
        return cached


def _default_chunk(nnzb: int, n_lanes: int) -> int:
    # ~4 chunks per lane of slack keeps LPT's quantization under a quarter
    # shard (the reference's rule)
    return max(1, -(-nnzb // (4 * n_lanes))) if nnzb else 1


def plan_spmm(a: BlockCSR, *, n_lanes: int = 8,
              chunk: Optional[int] = None,
              row_atomic: bool = False,
              fused: str = "auto") -> SpmmPlan:
    """Load-balanced lane schedule from BlockCSR metadata (the reference's
    ``plan_spmm``: rows split into ≤ ``chunk`` block chunks, LPT-packed,
    each lane row-sorted; ``row_atomic`` keeps rows whole).  ``"auto"``
    resolves to ``"rmw"`` as in the reference."""
    if not isinstance(a, BlockCSR):
        raise NotImplementedError(
            "plan_spmm over ELL / bitmap formats is not ported yet; pass a "
            "BlockCSR")
    if n_lanes < 1:
        raise ValueError(f"n_lanes={n_lanes} < 1")
    if fused == "auto":
        fused = "rmw"
    if row_atomic and chunk is not None:
        raise ValueError(
            f"row_atomic=True keeps rows whole, so chunk={chunk} would be "
            f"silently ignored (and a plan/cache key built from it would "
            f"alias distinct plans) — drop one of the two")
    rptr = np.asarray(a.row_ptr).astype(np.int64)
    cols = np.asarray(a.block_col).astype(np.int32)
    gm = a.n_block_rows
    nnzb = int(rptr[-1])
    stats = bsr_stats(a)
    if row_atomic:
        chunk = 0
    elif chunk is None:
        chunk = _default_chunk(nnzb, n_lanes)
    elif chunk < 1:
        raise ValueError(f"chunk={chunk} < 1")

    # 1. split rows into chunks of <= `chunk` blocks: (row, lo, hi)
    chunks: List[Tuple[int, int, int]] = []
    for i in range(gm):
        lo, hi = int(rptr[i]), int(rptr[i + 1])
        if hi <= lo:
            continue
        if row_atomic:
            chunks.append((i, lo, hi))
        else:
            for s in range(lo, hi, chunk):
                chunks.append((i, s, min(s + chunk, hi)))

    # 2. LPT packing: longest chunk first onto the least-loaded lane
    chunks.sort(key=lambda c: (-(c[2] - c[1]), c[0], c[1]))
    lanes, _ = _lpt_pack([(c[2] - c[1], c) for c in chunks], n_lanes)

    # 3. PSB contiguity: same-row chunks adjacent within each lane
    for lane in lanes:
        lane.sort(key=lambda c: (c[0], c[1]))

    steps = max(1, max((sum(c[2] - c[1] for c in lane) for lane in lanes),
                       default=0))
    order = np.zeros((n_lanes, steps), np.int32)
    step_row = np.zeros((n_lanes, steps), np.int32)
    step_col = np.full((n_lanes, steps), -1, np.int32)
    written = np.zeros((n_lanes, gm), bool)
    n_real = 0
    for l, lane in enumerate(lanes):
        t = 0
        last_row = 0
        for (i, lo, hi) in lane:
            ln = hi - lo
            order[l, t:t + ln] = np.arange(lo, hi, dtype=np.int32)
            step_row[l, t:t + ln] = i
            step_col[l, t:t + ln] = cols[lo:hi]
            written[l, i] = True
            last_row = i
            t += ln
        n_real += t
        if t < steps:
            # pads extend the last run: same row, col = -1
            step_row[l, t:] = last_row

    return SpmmPlan(order=order, step_row=step_row, step_col=step_col,
                    written=written, chunk=chunk, n_block_rows=gm,
                    n_real_steps=n_real, stats=stats,
                    block_m=a.block_shape[0], block_k=a.block_shape[1],
                    fused=fused)


# --------------------------------------------------------------------------
# SpMM training plan: forward + transpose-side schedules for the backward
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpmmTrainPlan:
    """Forward plan plus everything the ``maple_spmm`` backward needs,
    built once per weight pattern (the reference's ``SpmmTrainPlan``).

    ``dB = Aᵀ·dC`` runs the planned compact kernel on the transposed
    block pattern (``bwd``); ``dA = (dC·Bᵀ)`` sampled at A's pattern runs
    the block SDDMM over ``block_row`` / ``block_col``.

    * ``fwd`` / ``bwd`` — lane schedules for A and Aᵀ;
    * ``t_perm`` — gather taking ``a.blocks`` slots to Aᵀ live-slot order;
    * ``t_block_row`` / ``t_block_col`` / ``t_row_ptr`` — Aᵀ metadata at
      the source capacity, pads per the container contract;
    * ``block_row`` / ``block_col`` — host copies of A's metadata.
    """

    fwd: SpmmPlan
    bwd: SpmmPlan
    t_perm: np.ndarray        # (nnzb,) int32 — Aᵀ live slot -> A slot
    t_block_row: np.ndarray   # (n_blocks_max,) int32
    t_block_col: np.ndarray   # (n_blocks_max,) int32, -1 pads
    t_row_ptr: np.ndarray     # (n_block_cols + 1,) int32
    block_row: np.ndarray     # (n_blocks_max,) int32
    block_col: np.ndarray     # (n_blocks_max,) int32, -1 pads
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    n_blocks_max: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def n_block_rows(self) -> int:
        return self.fwd.n_block_rows

    def predicted_cycles(self) -> Dict[str, float]:
        """Fwd + Aᵀ cycle predictions (the ``ExecutionPlan`` keys), plus
        ``fwd_plan`` / ``at_plan``."""
        f = self.fwd.predicted_cycles()
        b = self.bwd.predicted_cycles()
        out = {k: f[k] + b[k] for k in f}
        out["fwd_plan"] = f["plan"]
        out["at_plan"] = b["plan"]
        return out

    def on_device(self, device: torch.device) -> dict:
        """The backward's index tensors on ``device`` (``t_perm`` as int64
        for the payload gather; A's ``block_row`` / ``block_col`` as int32
        for the SDDMM), copied once per device."""
        key = str(device)
        cached = self._on_device.get(key)
        if cached is None:
            as_t = lambda a, dt: torch.from_numpy(
                np.ascontiguousarray(a).astype(dt)).to(device)
            cached = {"t_perm": as_t(self.t_perm, np.int64),
                      "block_row": as_t(self.block_row, np.int32),
                      "block_col": as_t(self.block_col, np.int32)}
            self._on_device[key] = cached
        return cached


def _single_device_only(n_shards, n_col_shards) -> None:
    if (n_shards is not None and n_shards > 1) or \
            (n_col_shards is not None and n_col_shards > 1):
        raise NotImplementedError("partitioned training plans (n_shards / "
                                  "n_col_shards > 1) are not ported yet")


def plan_spmm_vjp(a: BlockCSR, *, n_lanes: int = 8,
                  chunk: Optional[int] = None,
                  row_atomic: bool = False,
                  fused: str = "auto",
                  n_shards: Optional[int] = None,
                  n_col_shards: Optional[int] = None,
                  fwd: Optional[SpmmPlan] = None) -> SpmmTrainPlan:
    """Build the forward plan (or take the given ``fwd``) and the
    transpose-side plan with it, on the host, as the reference does.
    Single-device only."""
    _single_device_only(n_shards, n_col_shards)
    if fwd is None:
        fwd = plan_spmm(a, n_lanes=n_lanes, chunk=chunk,
                        row_atomic=row_atomic, fused=fused)
    return transpose_train_plan(
        a, fwd, lambda at: plan_spmm(at, n_lanes=n_lanes, chunk=chunk,
                                     row_atomic=row_atomic, fused=fused))


def transpose_train_plan(a: BlockCSR, fwd, plan_at) -> SpmmTrainPlan:
    """Aᵀ metadata at the source capacity, a metadata-only Aᵀ stand-in
    handed to ``plan_at``, and the assembled :class:`SpmmTrainPlan`."""
    cap = a.n_blocks_max
    bm, bk = a.block_shape
    perm, t_block_row, t_block_col, t_rptr, nnzb = bsr_transpose_meta(
        a, pad_to=cap)
    at_pattern = BlockCSR(
        blocks=torch.zeros((cap, 1, 1)), block_col=t_block_col,
        block_row=t_block_row, row_ptr=t_rptr,
        shape=(a.shape[1], a.shape[0]), block_shape=(bk, bm))
    return SpmmTrainPlan(
        fwd=fwd, bwd=plan_at(at_pattern), t_perm=perm[:nnzb],
        t_block_row=t_block_row, t_block_col=t_block_col, t_row_ptr=t_rptr,
        block_row=np.asarray(a.block_row).astype(np.int32).copy(),
        block_col=np.asarray(a.block_col).astype(np.int32).copy(),
        shape=a.shape, block_shape=a.block_shape, n_blocks_max=cap)


# --------------------------------------------------------------------------
# SpGEMM: the symbolic phase + work-balanced lane schedule
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpgemmPlan(ExecutionPlan):
    """Element-granular plan for ``maple_spgemm``: the symbolic phase's
    output, every array equal to the reference's.

    One step consumes one live A non-zero and the whole B row its
    ``col_id`` selects (``step_col``).  On top of the lane schedule:

    * ``out_row_ptr`` / ``out_cols`` — the exact pattern of C, columns
      sorted within rows; ``row_upper`` the O(nnz_a) a-priori bound;
    * ``lc`` — the PSB width, the longest output row (>= 1);
    * ``scatter_pos[i·la + t, u]`` — the position within output row i of
      the partial A[i, t-th nnz] · B[k', u-th nnz], -1 where dead (Eq. (8)
      made explicit);
    * ``a_gather`` / ``a_live``, ``b_gather`` / ``b_live`` — the ELL slot
      maps of A and B; ``la`` / ``lb`` their widths;
    * ``lane_work`` — partial products per lane (the balancing target).

    Pad steps point ``step_row`` at the sacrificial row ``n_rows``.  Rows
    are atomic (``chunk = 0``).  The Hopper kernels do not walk lanes: they
    take one warp per row, and :meth:`on_device` gives them the plan in
    A's CSR slot order.
    """

    out_row_ptr: np.ndarray   # (n_rows + 1,) int64 — exact C pattern
    out_cols: np.ndarray      # (nnz_c,) int32, column-sorted within rows
    row_upper: np.ndarray     # (n_rows,) int64 — a-priori nnz(C[i,:]) bound
    lc: int                   # PSB width = longest output row (>= 1)
    scatter_pos: np.ndarray   # (n_rows * la, lb) int32, -1 dead
    a_gather: np.ndarray      # (n_rows * la,) int32 — slot -> A nnz index
    a_live: np.ndarray        # (n_rows * la,) bool
    b_gather: np.ndarray      # (n_rows_b, lb) int32
    b_live: np.ndarray        # (n_rows_b, lb) bool
    la: int                   # ELL width of A
    lb: int                   # ELL width of B (panel width)
    lane_work: np.ndarray     # (n_lanes,) int64 — partial products per lane
    shape_a: Tuple[int, int]
    shape_b: Tuple[int, int]
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)
    _patterns: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def nnz_c(self) -> int:
        return int(self.out_row_ptr[-1])

    def out_pattern(self, cap: int) -> Tuple[np.ndarray, np.ndarray]:
        """C's padded-CSR ``(col_id, row_ptr)`` at capacity ``cap``, int32,
        built once per capacity and shared by every result of the plan:
        read-only, so no holder can change another's pattern."""
        cached = self._patterns.get(cap)
        if cached is None:
            col_id = np.full(cap, -1, np.int32)
            col_id[:self.nnz_c] = self.out_cols
            cached = (col_id, self.out_row_ptr.astype(np.int32))
            for arr in cached:
                arr.flags.writeable = False
            self._patterns[cap] = cached
        return cached

    def _realized_makespan(self) -> float:
        # the busiest lane's partial products: a slot costs its B row's
        # length, not one flat step
        return float(self.lane_work.max(initial=0))

    def on_device(self, device: torch.device) -> dict:
        """The numeric kernels' view of the plan on ``device``, derived
        from the host arrays, copied once per device and cached.

        In A's CSR slot order (``a_gather[i·la + t] = a_rptr[i] + t``):

        * ``a_rptr`` (m + 1,) int32; ``a_cols`` / ``a_rows`` (nnz_a,)
          int32 — the B row each live A slot consumes, and its output row;
        * ``b_rptr`` (k + 1,) int32 — B's row pointer (the panels);
        * ``part_ptr`` (nnz_a + 1,) int64 and ``pos`` (P,) int32 — the live
          entries of ``scatter_pos``: slot s's partials sit at
          ``pos[part_ptr[s] : part_ptr[s + 1]]``, one per entry of its B
          row, so dead entries take no bytes on the card;
        * ``out_rptr`` (m + 1,) int64 — C's row pointer;
        * ``t_ptr`` (k + 1,) int32 and ``t_perm`` (nnz_a,) int32 — A's
          column fibers (the rows of Aᵀ): the slots that consume B row k'
          are ``t_perm[t_ptr[k'] : t_ptr[k' + 1]]``, in row order.
        """
        key = str(device)
        cached = self._on_device.get(key)
        if cached is not None:
            return cached
        m, k = self.shape_a[0], self.shape_b[0]
        la = self.la
        a_len = self.a_live.reshape(m, la).sum(axis=1)
        a_rptr = np.zeros(m + 1, np.int64)
        np.cumsum(a_len, out=a_rptr[1:])
        live_slots = np.nonzero(self.a_live)[0]
        slot_col = np.full(self.a_live.size, -1, np.int32)
        live_steps = self.step_col >= 0
        slot_col[self.order[live_steps]] = self.step_col[live_steps]
        a_cols = slot_col[live_slots]
        a_rows = (live_slots // la).astype(np.int32)
        b_len = self.b_live.sum(axis=1).astype(np.int64)
        b_rptr = np.zeros(k + 1, np.int64)
        np.cumsum(b_len, out=b_rptr[1:])
        part_ptr = np.zeros(live_slots.size + 1, np.int64)
        np.cumsum(b_len[a_cols], out=part_ptr[1:])
        sp = self.scatter_pos[live_slots]
        pos = sp[sp >= 0]
        if pos.size != part_ptr[-1]:
            raise ValueError("scatter_pos disagrees with the B panels: "
                             "the plan is inconsistent")
        t_perm, t_rows, _ = transpose_perm(a_rows, a_cols)
        t_ptr = np.zeros(k + 1, np.int64)
        np.cumsum(np.bincount(t_rows, minlength=k), out=t_ptr[1:])
        as_t = lambda arr, dt: torch.from_numpy(
            np.ascontiguousarray(arr, dtype=dt)).to(device)
        cached = {"a_rptr": as_t(a_rptr, np.int32),
                  "a_cols": as_t(a_cols, np.int32),
                  "a_rows": as_t(a_rows, np.int32),
                  "b_rptr": as_t(b_rptr, np.int32),
                  "part_ptr": as_t(part_ptr, np.int64),
                  "pos": as_t(pos, np.int32),
                  "out_rptr": as_t(self.out_row_ptr, np.int64),
                  "t_ptr": as_t(t_ptr, np.int32),
                  "t_perm": as_t(t_perm, np.int32)}
        self._on_device[key] = cached
        return cached


def plan_spgemm(a: CSR, b: CSR, *, n_lanes: int = 8,
                balance: str = "work") -> SpgemmPlan:
    """Symbolic SpGEMM phase: exact C pattern + work-balanced lane schedule
    (the reference's ``plan_spgemm``, host numpy over metadata).

    ``balance`` weights rows for LPT lane packing: ``"work"`` by
    Σ nnz(B[k',:]) (the partial products), ``"fibers"`` by nnz(A[i,:]),
    ``"none"`` one lane, rows in order.  ``BlockCSR`` operands lower to
    the element pattern they store (``core.formats.as_element_csr``).
    """
    if not isinstance(a, CSR):
        a = as_element_csr(a)
    if not isinstance(b, CSR):
        b = as_element_csr(b)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    if n_lanes < 1:
        raise ValueError(f"n_lanes={n_lanes} < 1")
    if balance not in ("work", "fibers", "none"):
        raise ValueError(f"unknown balance {balance!r}")
    m, n = a.shape[0], b.shape[1]
    a_rptr = np.asarray(a.row_ptr).astype(np.int64)
    a_cols = np.asarray(a.col_id).astype(np.int32)
    a_len = np.diff(a_rptr)
    b_len = np.diff(np.asarray(b.row_ptr).astype(np.int64))
    # the exact pattern is computed below; stats.nnz_c is patched after
    stats = analyze_spgemm(a, b, exact_output=False)

    la = max(int(a_len.max(initial=0)), 1)
    lb = max(int(b_len.max(initial=0)), 1)
    a_gather, a_live = ell_slots(a.row_ptr, la)         # (m, la)
    b_gather, b_live = ell_slots(b.row_ptr, lb)         # (k, lb)

    row_upper = spgemm_row_upper_bounds(a, b)
    scatter = np.full((m * la, lb), -1, np.int32)
    out_row_ptr = np.zeros(m + 1, np.int64)
    if row_upper.sum() > 0:
        a_slot, out_i, out_j, b_off = expand_partials(a, b)
        keys = out_i * np.int64(n) + out_j
        uniq, gpos = np.unique(keys, return_inverse=True)
        out_cols = (uniq % n).astype(np.int32)
        np.cumsum(np.bincount((uniq // n).astype(np.int64), minlength=m),
                  out=out_row_ptr[1:])
        a_off = a_slot - a_rptr[out_i]                  # ELL lane of A slot
        scatter[out_i * la + a_off, b_off] = \
            (gpos - out_row_ptr[out_i]).astype(np.int32)
    else:
        out_cols = np.zeros(0, np.int32)
    stats = dataclasses.replace(stats, nnz_c=int(out_cols.size))
    lc = max(int(np.diff(out_row_ptr).max(initial=0)), 1)

    # lane schedule: whole rows, LPT by the chosen weight
    rows = [i for i in range(m) if a_len[i] > 0]
    if balance == "none":
        n_lanes = 1
        lanes: List[List[int]] = [rows]
    else:
        weight = stats.row_partials if balance == "work" else a_len
        weighted = sorted(((int(weight[i]), i) for i in rows),
                          key=lambda t: (-t[0], t[1]))
        lanes, _ = _lpt_pack(weighted, n_lanes)
        for lane in lanes:
            lane.sort()

    steps = max(1, max((sum(int(a_len[i]) for i in lane) for lane in lanes),
                       default=0))
    order = np.zeros((n_lanes, steps), np.int32)
    step_row = np.full((n_lanes, steps), m, np.int32)   # pads -> row m
    step_col = np.full((n_lanes, steps), -1, np.int32)
    written = np.zeros((n_lanes, m), bool)
    lane_work = np.zeros(n_lanes, np.int64)
    n_real = 0
    for l, lane in enumerate(lanes):
        t = 0
        for i in lane:
            ln = int(a_len[i])
            lo = int(a_rptr[i])
            order[l, t:t + ln] = i * la + np.arange(ln, dtype=np.int32)
            step_row[l, t:t + ln] = i
            step_col[l, t:t + ln] = a_cols[lo:lo + ln]
            written[l, i] = True
            lane_work[l] += int(stats.row_partials[i])
            t += ln
        n_real += t

    return SpgemmPlan(
        order=order, step_row=step_row, step_col=step_col, written=written,
        chunk=0, n_rows=m, n_real_steps=n_real, stats=stats,
        out_row_ptr=out_row_ptr, out_cols=out_cols, row_upper=row_upper,
        lc=lc, scatter_pos=scatter, a_gather=a_gather.reshape(-1),
        a_live=a_live.reshape(-1), b_gather=b_gather, b_live=b_live,
        la=la, lb=lb, lane_work=lane_work, shape_a=a.shape, shape_b=b.shape)
