"""Public entry point of the Maple SpMM (port of
``repro.kernels.ops.maple_spmm``), forward and backward.

The wrapper owns everything that is not the kernel: argument checks (the
reference's plan-mismatch raises, same types and messages), schedule
selection and planning, device copies of the metadata, the deterministic
f32 merge of the compact layout, and the backward (:class:`_SpmmFunction`):
dB = Aᵀ·dC on the planned compact kernel over the transpose-side plan,
dA through the block SDDMM kernel.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.csr import BlockCSR, transpose_payload
from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr
from repro_torch.kernels.maple_spmm import maple_spmm_compact, maple_spmm_naive
from repro_torch.kernels.schedule import (SpmmPlan, SpmmTrainPlan, plan_spmm,
                                          plan_spmm_vjp)


def maple_spmm(a: BlockCSR, b_dense: torch.Tensor, *, bn: int = 128,
               schedule: str = "balanced", n_lanes: int = 8,
               chunk: int | None = None, n_shards: int | None = None,
               n_col_shards: int | None = None,
               plan: SpmmPlan | SpmmTrainPlan | str | None = None,
               reorder: bool | str = False) -> torch.Tensor:
    """C = A_bsr @ B with the Maple block dataflow.  Differentiable in
    ``a.blocks`` and ``b_dense``.

    ``b_dense`` is one ``(K, N)`` right-hand side or a batch ``(G, K, N)``
    sharing A's structure; ``N`` may be ragged.  ``schedule``:

    * ``"balanced"`` (default) / ``"row_atomic"`` — plan with
      :func:`~repro_torch.kernels.schedule.plan_spmm` (or use the prebuilt
      ``plan``) and run the planned kernel in the compact layout, whose
      split-row partials merge in f32 in slot order, then cast once.
    * ``"naive"`` — the construction-order walk: one kernel launch, no
      plan, no host work per call beyond argument checks.

    **Backward** (a ``torch.autograd.Function``): dB = Aᵀ·dC runs the
    compact kernel on the transpose-side plan of an
    :class:`~repro_torch.kernels.schedule.SpmmTrainPlan` and merges
    deterministically as the forward does; dA is the block SDDMM sampled
    at A's pattern, masked on ``block_col >= 0`` and cast to the payload's
    dtype.  Metadata gets no gradient.  Pass the train plan
    (``plan_spmm_vjp``) to build it once per weight; without one, the
    first backward of a call builds it from the call's forward plan (the
    naive schedule plans afresh), as the reference does eagerly.

    Not ported yet (raise ``NotImplementedError``): ELL / bitmap operands,
    ``schedule="partitioned"`` and ``n_shards`` / ``n_col_shards``,
    ``plan="auto"`` and ``reorder``.
    """
    if not isinstance(a, BlockCSR):
        raise NotImplementedError("ELL / bitmap operands are not ported yet; "
                                  "pass a BlockCSR")
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
    if isinstance(plan, str):
        if plan != "auto":
            raise ValueError(f"unknown plan {plan!r}; pass a prebuilt plan "
                             f"or 'auto'")
        raise NotImplementedError("plan='auto' (the autotuner) is not "
                                  "ported yet")
    if n_shards is not None or n_col_shards is not None:
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
            # block, and run the compact kernel on the transpose-side plan
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
    """Planned SpMM in the compact layout → merged ``(G, M, N)`` f32 (the
    cast is the caller's).  The reference also keeps an in-kernel
    read-modify-write layout (``plan.fused == "rmw"``) that it runs only
    interpreted; compiled calls there, and every call here, take compact."""
    d = plan.on_device(b3.device)
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
