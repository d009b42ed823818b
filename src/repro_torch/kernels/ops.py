"""Public entry points of the Maple kernels (port of
``repro.kernels.ops``): ``maple_spmm``, ``maple_spgemm`` and
``maple_spmspm``, forward and backward; ``moe_expert_gemm`` and
``local_block_attention``, forward only.

The wrappers own everything that is not a kernel: argument checks (the
reference's raises, same types and messages), format lowering, schedule
selection, planning and autotuning, row reordering, device copies of the
metadata, the deterministic f32 merge of the SpMM's compact layout, and
the backwards.  :class:`_SpmmFunction`: dB = Aᵀ·dC on the planned kernel
of the transpose-side plan's layout, dA through the block SDDMM kernel.
:class:`_SpgemmValueFunction`: dA through the CSR SDDMM kernel, dB through
the fiber-order dB kernel.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.core.csr import (CSR, BlockCSR, grow_nnz_max,
                                  transpose_payload)
from repro_torch.kernels.block_attn import (block_attention,
                                           local_window_kv_map)
from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr, maple_sddmm_csr
from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                              maple_spgemm_numeric)
from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                            maple_spmm_naive,
                                            maple_spmm_planned)
from repro_torch.kernels.maple_spmspm import maple_spmspm_ell
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.reorder import apply_reorder
from repro_torch.kernels.schedule import (SpgemmPlan, SpmmPlan, SpmmTrainPlan,
                                          plan_spgemm, plan_spmm,
                                          plan_spmm_vjp)


def _validate_enabled() -> bool:
    """``MAPLE_VALIDATE=1`` arms the operands' pad-contract checks at the
    entry points.  Off by default: the checks read payloads on the host,
    a device sync per call."""
    return os.environ.get("MAPLE_VALIDATE", "0") not in ("", "0")


def _maybe_validate(*operands) -> None:
    """``check_pad_contract`` on each sparse operand when the
    ``MAPLE_VALIDATE`` gate is armed."""
    if not _validate_enabled():
        return
    for op in operands:
        if isinstance(op, (CSR, BlockCSR, formats.EllPack,
                           formats.BitmapBlocked)):
            op.check_pad_contract()


def maple_spmm(a: "formats.BlockFormat", b_dense: torch.Tensor, *,
               bn: int = 128,
               schedule: str = "balanced", n_lanes: int = 8,
               chunk: int | None = None, n_shards: int | None = None,
               n_col_shards: int | None = None,
               plan: SpmmPlan | SpmmTrainPlan | str | None = None,
               reorder: bool | str = False) -> torch.Tensor:
    """C = A_bsr @ B with the Maple block dataflow.  Differentiable in
    ``a.blocks`` and ``b_dense``.

    ``a`` is any blocked format (``BlockCSR``, ``EllPack``,
    ``BitmapBlocked``); ELL and bitmap operands lower through
    ``core.formats.as_block_csr`` at entry (one host pattern walk, one
    payload gather), so every format runs bit-identically.  ``b_dense`` is
    one ``(K, N)`` right-hand side or a batch ``(G, K, N)`` sharing A's
    structure; ``N`` may be ragged.  ``schedule``:

    * ``"balanced"`` (default) / ``"row_atomic"`` — plan with
      :func:`~repro_torch.kernels.schedule.plan_spmm` (or use the prebuilt
      ``plan``) and run the layout the plan carries: ``"rmw"`` (the
      default) sums each row's runs in lane order inside one kernel,
      ``"compact"`` flushes per-run slots and merges them in f32 in slot
      order; both round to the output type once.
    * ``"naive"`` — the construction-order walk: one kernel launch, no
      plan, no host work per call beyond argument checks.

    ``plan="auto"`` searches the schedule knob space instead
    (:func:`~repro_torch.kernels.autotune.auto_plan`, memoized per
    pattern); ``reorder`` rides it (``True`` forces the similarity row
    reordering, ``"auto"`` lets the search decide).  A plan that carries a
    ``RowReorder`` (``plan_reordered_spmm``) runs on A's permuted
    block-rows and the output rows are permuted back.

    **Backward** (a ``torch.autograd.Function``): dB = Aᵀ·dC runs the
    transpose-side plan of an
    :class:`~repro_torch.kernels.schedule.SpmmTrainPlan` in its layout;
    dA is the block SDDMM sampled at A's pattern, masked on ``block_col >=
    0`` and cast to the payload's dtype.  Metadata gets no gradient.  Pass
    the train plan (``plan_spmm_vjp``) to build it once per weight;
    without one, the first backward of a call builds it from the call's
    forward plan (the naive schedule plans afresh), as the reference does
    eagerly.

    ``MAPLE_VALIDATE=1`` checks A's pad contract at entry.  Not ported yet
    (raise ``NotImplementedError``): ``schedule="partitioned"`` and
    ``n_shards`` / ``n_col_shards`` above 1.
    """
    _maybe_validate(a)
    if not isinstance(a, BlockCSR):
        a = formats.as_block_csr(a)
    if a.stacked:
        raise ValueError("a holds a stack of layers; pass one (a.layer(i))")
    if schedule not in ("balanced", "row_atomic", "naive", "partitioned"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "naive" and plan is not None:
        raise ValueError("schedule='naive' does not execute a plan; "
                         "drop `plan` or pick a planned schedule")
    if reorder is not False and not (isinstance(plan, str)
                                     and plan == "auto"):
        raise ValueError(
            "reorder is an autotune knob and requires plan='auto'; to "
            "run a reordered schedule directly, prebuild it with "
            "kernels.reorder.plan_reordered_spmm and pass it as `plan`")
    auto_planned = False
    if isinstance(plan, str):
        if plan != "auto":
            raise ValueError(f"unknown plan {plan!r}; pass a prebuilt plan "
                             f"or 'auto'")
        from repro_torch.kernels.autotune import auto_plan  # imports ops
        plan = auto_plan(a, n_shards=n_shards, n_col_shards=n_col_shards,
                         reorder=reorder)
        auto_planned = True
    if (n_shards is not None or n_col_shards is not None) \
            and not auto_planned:
        if plan is not None:
            raise ValueError(
                "n_shards/n_col_shards was given but the prebuilt "
                "plan is single-device — build it with "
                "plan_partitioned_spmm / plan_spmm_vjp(n_shards=...) "
                "instead")
        if schedule != "partitioned":
            raise ValueError("n_shards/n_col_shards only applies to "
                             "schedule='partitioned' (or pass a prebuilt "
                             "PartitionedSpmmPlan)")
    if schedule == "partitioned":
        raise NotImplementedError("schedule='partitioned' is not ported yet")
    train = plan if isinstance(plan, SpmmTrainPlan) else None
    if train is not None:
        plan = train.fwd
    if plan is not None and not isinstance(plan, SpmmPlan):
        raise NotImplementedError(
            f"{type(plan).__name__} plans are not ported yet; pass a "
            f"plan_spmm plan")
    if b_dense.dim() not in (2, 3):
        raise ValueError(
            f"B must be (K, N) or (G, K, N), got {tuple(b_dense.shape)}")
    if b_dense.shape[-2] != a.shape[1]:
        raise ValueError(f"contraction mismatch: A is {a.shape}, B has "
                         f"K={b_dense.shape[-2]}")
    batched = b_dense.dim() == 3
    b3 = (b_dense if batched else b_dense[None]).contiguous()
    # a reordered plan runs on A's permuted block-rows (the payload gather
    # sits outside the autograd Function, so dA scatters back to the
    # original slots); its output rows are permuted back below
    rr = getattr(plan, "reorder", None) if plan is not None else None
    if rr is not None:
        if rr.shape != a.shape or rr.block_shape != a.block_shape:
            raise ValueError(
                f"reordered plan was built for {rr.shape} / blocks "
                f"{rr.block_shape}, operand is {a.shape} / blocks "
                f"{a.block_shape} — was it built for this weight?")
        a = apply_reorder(a, rr)
    if plan is not None:
        if plan.n_block_rows != a.n_block_rows:
            raise ValueError(
                f"plan is for {plan.n_block_rows} block-rows, "
                f"operand has {a.n_block_rows}")
        if plan.order.size and int(plan.order.max()) >= a.n_blocks_max:
            raise ValueError("plan indexes blocks beyond the operand's "
                             "capacity — was it built for this weight?")
        if (plan.block_m, plan.block_k) != a.block_shape:
            raise ValueError(
                f"plan was built for blocks "
                f"({plan.block_m}, {plan.block_k}), operand blocks are "
                f"{a.block_shape} — was it built for this weight?")
    if plan is None and schedule != "naive":
        plan = plan_spmm(a, n_lanes=n_lanes, chunk=chunk,
                         row_atomic=(schedule == "row_atomic"))
    if train is not None:
        train_thunk = lambda: train
    else:
        # built on the first backward only, from the plan this call ran
        memo = []

        def train_thunk(fwd=plan, ra=(schedule == "row_atomic")):
            if not memo:
                memo.append(plan_spmm_vjp(a, n_lanes=n_lanes, chunk=chunk,
                                          row_atomic=ra, fwd=fwd))
            return memo[0]
    out = _SpmmFunction.apply(a.blocks, b3, a, plan, train_thunk, bn)
    if rr is not None:
        # permuted row p holds original row rr.perm[p]: gather row i from
        # position rr.inv[i]
        out = out.index_select(1, torch.from_numpy(
            rr.inv.astype(np.int64)).to(out.device))
    return out if batched else out[0]


class _SpmmFunction(torch.autograd.Function):
    """The differentiable boundary of :func:`maple_spmm` (the reference's
    ``_spmm_call`` custom VJP).  Inputs are the payload and the dense
    operand; the container, the plan and the lazy train-plan thunk ride
    along as constants."""

    @staticmethod
    def forward(ctx, blocks, b3, a: BlockCSR, plan, train_thunk, bn: int):
        if plan is not None:
            # split-row partials merge in f32; round once, like the naive
            # single-accumulator walk
            out = _planned_spmm_f32(blocks, b3, plan, bn=bn).to(b3.dtype)
        else:
            meta = _meta_on(a, b3.device)
            out = maple_spmm_naive(blocks, meta["row_ptr"],
                                   meta["block_col"], b3, bn=bn)
        ctx.save_for_backward(blocks, b3)
        ctx.train_thunk = train_thunk
        ctx.bn = bn
        return out

    @staticmethod
    def backward(ctx, dc):
        blocks, b3 = ctx.saved_tensors
        need_da, need_db = ctx.needs_input_grad[:2]
        if not (need_da or need_db):
            return None, None, None, None, None, None
        train = ctx.train_thunk()
        dc = dc.to(b3.dtype).contiguous()
        d = train.on_device(dc.device)
        bm, bk = train.block_shape
        da = db = None
        if need_db:
            # dB = Aᵀ·dC: gather the payload into Aᵀ slot order, swap each
            # block, and run the transpose-side plan in its layout
            at_blocks = transpose_payload(blocks, d["t_perm"],
                                          train.n_blocks_max)
            db = _planned_spmm_f32(at_blocks, dc, train.bwd,
                                   bn=ctx.bn).to(b3.dtype)
        if need_da:
            # dA = (dC·Bᵀ) sampled at A's pattern; pads masked in-kernel
            # and again here, as the reference does
            da = maple_sddmm_bsr(dc, b3, d["block_row"], d["block_col"],
                                 bm=bm, bk=bk, bn=ctx.bn)
            live = (d["block_col"] >= 0)[:, None, None]
            da = torch.where(live, da, 0.0).to(blocks.dtype)
        return da, db, None, None, None, None


def _meta_on(a: BlockCSR, device: torch.device) -> dict:
    """The container's metadata on ``device``, copied once and cached on
    the container (shared by the layers of a stack)."""
    meta = a.device_meta.get(str(device))
    if meta is None:
        meta = {"row_ptr": torch.from_numpy(a.row_ptr).to(device),
                "block_col": torch.from_numpy(a.block_col).to(device)}
        a.device_meta[str(device)] = meta
    return meta


def _planned_spmm_f32(blocks, b3, plan: SpmmPlan, *, bn: int) -> torch.Tensor:
    """Planned SpMM → merged ``(G, M, N)`` f32 (the cast is the caller's),
    in the layout the plan carries, on every device: ``"rmw"`` runs B4,
    which sums each row's runs in lane order; ``"compact"`` runs B1 into
    per-run slots and merges them in slot order.  The two agree bit for
    bit on one plan.  (The reference runs rmw only interpreted: Mosaic
    cannot re-read a revisited output tile, so its compiled calls take
    compact.)"""
    d = plan.on_device(b3.device)
    if plan.fused == "rmw":
        return maple_spmm_planned(blocks, d["order"], d["step_col"],
                                  d["row_runs"], d["row_run_ptr"], b3, bn=bn)
    bm = plan.block_m
    n_slots = plan.n_lanes * plan.r_max
    tiles = maple_spmm_compact(blocks, d["order"], d["step_col"], d["runs"],
                               b3, n_slots=n_slots, bn=bn)
    g, n = b3.shape[0], b3.shape[-1]
    return _scatter_merge_f32(tiles.view(g, n_slots, bm, n), d["merge"],
                              gm=plan.n_block_rows)


def _scatter_merge_f32(tiles: torch.Tensor,
                       ranks: List[Tuple[torch.Tensor, torch.Tensor]], *,
                       gm: int) -> torch.Tensor:
    """Merge compact flush slots ``(G, n_slots, bm, N)`` into their
    block-rows in f32, deterministically.

    ``ranks`` is ``SpmmPlan.merge_ranks`` on the tiles' device: rank k
    lists each row's k-th live slot in slot order, so the rows of one
    rank are distinct and every update below is a gather, an add and a
    scatter with no repeated target — no atomics, and a split row sums
    its slots in slot order, ``((0 + s0) + s1) + ...``, on every run.
    Dead slots appear in no rank: whatever they hold (they are never
    written) reaches no row.  Rows no slot names stay 0.
    """
    g, _, bm, n = tiles.shape
    merged = tiles.new_zeros((g, gm, bm, n))
    for slots, rows in ranks:
        merged.index_copy_(1, rows, merged.index_select(1, rows)
                           + tiles.index_select(1, slots))
    return merged.reshape(g, gm * bm, n)


# --------------------------------------------------------------------------
# element-granular CSR × CSR (the paper's protocol C = A×A)
# --------------------------------------------------------------------------

def csr_to_ell(a: CSR, max_row_len: int | None = None, *,
               truncate: bool = False):
    """Deprecated shim: :func:`repro_torch.core.formats.csr_to_ell` is the
    canonical home."""
    return formats.csr_to_ell(a, max_row_len, truncate=truncate)


def _as_csr(op) -> CSR:
    if isinstance(op, CSR):
        return op
    if isinstance(op, formats.BLOCK_FORMATS):
        # blocked operands expand to the element pattern they store
        return formats.as_element_csr(op)
    raise TypeError(
        "maple_spgemm takes CSR (or blocked format) operands; for dense B "
        "use maple_spmm or maple_spmspm")


def maple_spgemm(a: CSR, b: CSR, *, schedule: str = "balanced",
                 n_lanes: int = 8, plan: SpgemmPlan | None = None,
                 nnz_max: int | None = None) -> CSR:
    """C = A_csr @ B_csr → **padded CSR** via the two-phase Maple SpGEMM.
    Differentiable in ``a.value`` and ``b.value`` (pass the same CSR twice
    for A×A: both gradients add up).

    The symbolic phase (:func:`~repro_torch.kernels.schedule.plan_spgemm`,
    host numpy) fixes C's exact pattern and every partial product's
    position; the numeric phase (:func:`~repro_torch.kernels.maple_spgemm
    .maple_spgemm_numeric`, B5) computes the values with B held as
    compressed rows, never densified.  The result is a padded ``CSR``
    (``col_id = -1`` pads) at capacity :func:`~repro_torch.core.csr
    .grow_nnz_max` of nnz(C), unless ``nnz_max`` pins it.  Blocked
    operands lower to the element pattern they store.

    ``schedule`` packs A rows onto lanes: ``"balanced"`` (LPT by partial
    products), ``"row_atomic"`` (LPT by nnz(A[i,:])) or ``"naive"`` (one
    lane, rows in order).  The packing changes the plan, not the values:
    the kernel runs one warp per row.  A prebuilt ``plan`` skips the
    symbolic phase.

    **Backward** (a ``torch.autograd.Function``): dA through the CSR SDDMM
    kernel (B6), dB through the fiber-order kernel, both over the plan;
    one launch each per backward, none when nnz(C) is 0.
    ``MAPLE_VALIDATE=1`` checks both operands' pad contracts at entry.
    """
    _maybe_validate(a, b)
    a = _as_csr(a)
    b = _as_csr(b)
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"contraction mismatch: A is {a.shape}, B is {b.shape}")
    if schedule not in ("balanced", "row_atomic", "naive"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if plan is None:
        balance = {"balanced": "work", "row_atomic": "fibers",
                   "naive": "none"}[schedule]
        plan = plan_spgemm(a, b, n_lanes=n_lanes, balance=balance)
    else:
        if plan.shape_a != a.shape or plan.shape_b != b.shape:
            raise ValueError(
                f"plan is for {plan.shape_a} @ {plan.shape_b}, operands "
                f"are {a.shape} @ {b.shape}")
        # the largest slot a plan's gather names is its last live one
        # (dead ELL entries name slot 0): the reference's max(a_gather)
        if plan.stats.nnz_a > a.nnz_max:
            raise ValueError("plan indexes A slots beyond the operand's "
                             "capacity — was it built for this pattern?")
        if plan.stats.nnz_b > b.nnz_max:
            raise ValueError("plan indexes B slots beyond the operand's "
                             "capacity — was it built for this pattern?")
    m, n = a.shape[0], b.shape[1]
    nnz_c = plan.nnz_c
    cap = grow_nnz_max(nnz_c) if nnz_max is None else nnz_max
    if cap < nnz_c:
        raise ValueError(f"nnz_max={cap} < nnz(C)={nnz_c}")
    value = _SpgemmValueFunction.apply(a.value, b.value, plan, cap)
    col_id, row_ptr = plan.out_pattern(cap)
    return CSR(value=value, col_id=col_id, row_ptr=row_ptr, shape=(m, n))


def _spgemm_compaction_maps(plan: SpgemmPlan, cap: int):
    """Host (row, offset) of each output value slot, the reference's ELL →
    padded-CSR compaction map.  B5 writes C's values in place, so here it
    only names a C slot's row (``maple_spmspm``'s densify)."""
    m = plan.shape_a[0]
    nnz_c = plan.nnz_c
    lens = np.diff(plan.out_row_ptr)
    rows = np.zeros(cap, np.int32)
    offs = np.zeros(cap, np.int32)
    rows[:nnz_c] = np.repeat(np.arange(m, dtype=np.int32), lens)
    offs[:nnz_c] = (np.arange(nnz_c, dtype=np.int64)
                    - np.repeat(plan.out_row_ptr[:-1], lens)
                    ).astype(np.int32)
    return rows, offs


class _SpgemmValueFunction(torch.autograd.Function):
    """The differentiable boundary of :func:`maple_spgemm` (the reference's
    ``_spgemm_value_call`` custom VJP): (A values, B values) → C values.
    The plan and the capacity ride along as constants; the patterns get no
    gradient."""

    @staticmethod
    def forward(ctx, a_value, b_value, plan: SpgemmPlan, cap: int):
        ctx.save_for_backward(a_value, b_value)
        ctx.plan = plan
        if plan.nnz_c == 0:
            # nothing to compute: an all-zero pattern or a zero-dimension
            # operand
            return a_value.new_zeros((cap,))
        return maple_spgemm_numeric(a_value, b_value, plan, cap=cap)

    @staticmethod
    def backward(ctx, dvalue):
        a_value, b_value = ctx.saved_tensors
        plan = ctx.plan
        need_da, need_db = ctx.needs_input_grad[:2]
        if plan.nnz_c == 0:
            return (torch.zeros_like(a_value) if need_da else None,
                    torch.zeros_like(b_value) if need_db else None,
                    None, None)
        dc = dvalue.to(a_value.dtype).contiguous()
        da = db = None
        if need_da:
            da = maple_sddmm_csr(dc, b_value, plan,
                                 n_slots=a_value.shape[0]).to(a_value.dtype)
        if need_db:
            db = maple_spgemm_db(dc, a_value, plan,
                                 n_slots=b_value.shape[0]).to(b_value.dtype)
        return da, db, None, None


def maple_spmspm(a: CSR, b) -> torch.Tensor:
    """C = A_csr @ B → dense ``(M, N)``.

    A CSR ``b`` goes through the two-phase :func:`maple_spgemm` (B stays
    compressed) and only the result is densified, from its live nnz(C)
    prefix.  A dense ``b`` ``(K, N)`` takes the element walk
    (:func:`~repro_torch.kernels.maple_spmspm.maple_spmspm_ell`, B7) over
    ``csr_to_ell(a)``.
    """
    a = _as_csr(a)
    if isinstance(b, CSR):
        plan = plan_spgemm(a, b)
        c = maple_spgemm(a, b, plan=plan)
        rows, _ = _spgemm_compaction_maps(plan, plan.nnz_c)
        dev = c.value.device
        dense = c.value.new_zeros((a.shape[0], b.shape[1]))
        return dense.index_put(
            (torch.from_numpy(rows.astype(np.int64)).to(dev),
             torch.from_numpy(plan.out_cols.astype(np.int64)).to(dev)),
            c.value[:plan.nnz_c])
    if b.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(f"contraction mismatch: A is {a.shape}, B is "
                         f"{tuple(b.shape)}")
    values, col_ids = csr_to_ell(a)
    return maple_spmspm_ell(values, col_ids, b.contiguous())


# --------------------------------------------------------------------------
# MoE grouped GEMM
# --------------------------------------------------------------------------

def moe_expert_gemm(x_sorted: torch.Tensor, group_sizes: torch.Tensor,
                    w: torch.Tensor, *, bt: int = 128) -> torch.Tensor:
    """y[t] = x[t] @ w[expert(t)] for expert-sorted tokens.

    ``group_sizes`` must already be multiples of ``bt`` (capacity-padded:
    the MoE layer pads each expert's segment with zero rows), and T a
    multiple of ``bt``.  The tile → expert map (:func:`expert_of_tile`)
    is computed on the sizes' device; an empty group owns no tile and its
    weights are never read.  The reference needs D and F to be multiples
    of its 128-wide Pallas tiles; the port's kernel takes any D and F.
    """
    return moe_gemm(x_sorted,
                    expert_of_tile(group_sizes, x_sorted.shape[0] // bt, bt),
                    w, bt=bt)


def expert_of_tile(group_sizes: torch.Tensor, n_tiles: int,
                   bt: int) -> torch.Tensor:
    """``(n_tiles,)`` int32: the expert that owns each ``bt``-row tile of
    expert-sorted tokens, ``searchsorted(cumsum(group_sizes), tile start,
    right=True)`` on the sizes' device."""
    offsets = torch.cumsum(group_sizes.long(), dim=0)             # (E,)
    tile_starts = torch.arange(n_tiles, dtype=torch.int64,
                               device=group_sizes.device) * bt
    return torch.searchsorted(offsets, tile_starts,
                              right=True).to(torch.int32)


# --------------------------------------------------------------------------
# block-sparse local attention
# --------------------------------------------------------------------------

def local_block_attention(q, k, v, *, window: int, bq: int = 128,
                          bk: int = 128) -> torch.Tensor:
    """Causal local-window attention with banded-BSR tile skipping.

    q/k/v: (B, S, H, hd).  Tiles outside the window band are never fetched
    (the Maple zero-block skip); within-band masking is elementwise.  One
    kernel launch covers the whole batch.
    """
    kv_map = torch.from_numpy(local_window_kv_map(q.shape[1], window, bq,
                                                  bk)).to(q.device)
    return block_attention(q, k, v, kv_map, bq=bq, bk=bk, causal=True,
                           window=window)
