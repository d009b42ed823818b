"""Public entry point of the Maple SpMM (port of the forward half of
``repro.kernels.ops.maple_spmm``).

The wrapper owns everything that is not the kernel: argument checks (the
reference's plan-mismatch raises, same types and messages), schedule
selection and planning, device copies of the metadata, and the
deterministic f32 merge of the compact layout.  This slice is forward
only: an input that requires grad raises.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.csr import BlockCSR
from repro_torch.kernels.maple_spmm import maple_spmm_compact, maple_spmm_naive
from repro_torch.kernels.schedule import SpmmPlan, plan_spmm


def maple_spmm(a: BlockCSR, b_dense: torch.Tensor, *, bn: int = 128,
               schedule: str = "balanced", n_lanes: int = 8,
               chunk: int | None = None, n_shards: int | None = None,
               n_col_shards: int | None = None,
               plan: SpmmPlan | str | None = None,
               reorder: bool | str = False) -> torch.Tensor:
    """C = A_bsr @ B with the Maple block dataflow (forward only).

    ``b_dense`` is one ``(K, N)`` right-hand side or a batch ``(G, K, N)``
    sharing A's structure; ``N`` may be ragged.  ``schedule``:

    * ``"balanced"`` (default) / ``"row_atomic"`` — plan with
      :func:`~repro_torch.kernels.schedule.plan_spmm` (or use the prebuilt
      ``plan``) and run the planned kernel in the compact layout, whose
      split-row partials merge in f32 in slot order, then cast once.
    * ``"naive"`` — the construction-order walk: one kernel launch, no
      plan, no host work per call beyond argument checks.

    Not ported yet (raise ``NotImplementedError``): ELL / bitmap operands,
    ``schedule="partitioned"`` and ``n_shards`` / ``n_col_shards``,
    ``plan="auto"``, ``reorder``, and any backward pass.
    """
    if not isinstance(a, BlockCSR):
        raise NotImplementedError("ELL / bitmap operands are not ported yet; "
                                  "pass a BlockCSR")
    if a.stacked:
        raise ValueError("a holds a stack of layers; pass one (a.layer(i))")
    if a.blocks.requires_grad or b_dense.requires_grad:
        raise NotImplementedError(
            "maple_spmm backward not ported yet: the port is forward-only "
            "(call under torch.no_grad() or detach the inputs)")
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
    if plan is not None:
        out = _planned_spmm_f32(a.blocks, b3, plan, bn=bn).to(b3.dtype)
    else:
        meta = _meta_on(a, b3.device)
        out = maple_spmm_naive(a.blocks, meta["row_ptr"], meta["block_col"],
                               b3, bn=bn)
    return out if batched else out[0]


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
