"""Public entry points of the Maple kernels (port of
``repro.kernels.ops``): ``maple_spmm``, ``maple_spgemm`` and
``maple_spmspm``, forward and backward; ``moe_expert_gemm`` and
``local_block_attention``, forward only: under a gradient (grad mode on
and an operand that requires grad) both raise ``NotImplementedError``, as
the reference's do under ``jax.grad``.

The wrappers own everything that is not a kernel: argument checks (the
reference's raises, same types and messages), format lowering, schedule
selection, planning and autotuning, row reordering, device copies of the
metadata, the deterministic f32 merge of the SpMM's compact layout, and
the backwards.  :class:`_SpmmFunction`: dB = Aᵀ·dC on the planned kernel
of the transpose-side plan's layout, dA through the block SDDMM kernel;
a mesh-partitioned plan runs the same two kernels per shard
(:func:`_partitioned_spmm_f32`, :func:`_partitioned_sddmm_f32`).
:class:`_SpgemmValueFunction`: dA through the CSR SDDMM kernel, dB through
the fiber-order dB kernel.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import formats
from repro_torch.core.csr import (CSR, BlockCSR, grow_nnz_max,
                                  transpose_payload)
from repro_torch.distributed.sharding import (local_devices, partition_mesh,
                                              record_collective)
from repro_torch.kernels import _build
from repro_torch.kernels.block_attn import (block_attention,
                                           local_window_kv_map)
from repro_torch.kernels.maple_sddmm import (maple_sddmm_bsr, maple_sddmm_csr,
                                             sddmm_shard_meta)
from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                              maple_spgemm_numeric)
from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                            maple_spmm_naive,
                                            maple_spmm_planned)
from repro_torch.kernels.maple_spmspm import maple_spmspm_ell
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.partition import (PartitionedSpmmPlan,
                                           plan_partitioned_spmm,
                                           plan_partitioned_spmm_vjp)
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
    * ``"partitioned"`` — plan with
      :func:`~repro_torch.kernels.partition.plan_partitioned_spmm` over
      ``n_shards`` devices (default: every card ``partition_mesh`` can
      see, so 1 on one card) and ``n_col_shards`` column panels, and run
      it as a prebuilt :class:`PartitionedSpmmPlan` runs: B1 per shard
      (and per column panel), then the row-offset merge.

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

    ``n_shards`` / ``n_col_shards`` are never ignored: with a prebuilt
    plan they are checked against its mesh shape, without one they need
    ``schedule="partitioned"`` (the reference's raises).  A partitioned
    train plan takes dB per shard of its transpose side and dA per shard
    of its forward's block ownership.  ``MAPLE_VALIDATE=1`` checks A's
    pad contract at entry.
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
        got = plan.fwd if isinstance(plan, SpmmTrainPlan) else plan
        if got is not None:
            if not isinstance(got, PartitionedSpmmPlan):
                raise ValueError(
                    "n_shards/n_col_shards was given but the prebuilt "
                    "plan is single-device — build it with "
                    "plan_partitioned_spmm / plan_spmm_vjp(n_shards=...) "
                    "instead")
            if n_shards is not None and got.n_shards != n_shards:
                raise ValueError(
                    f"n_shards={n_shards} but the prebuilt plan has "
                    f"{got.n_shards} shards")
            if n_col_shards is not None \
                    and got.n_col_shards != n_col_shards:
                raise ValueError(
                    f"n_col_shards={n_col_shards} but the prebuilt plan "
                    f"has {got.n_col_shards} column shards")
        elif schedule != "partitioned":
            raise ValueError("n_shards/n_col_shards only applies to "
                             "schedule='partitioned' (or pass a prebuilt "
                             "PartitionedSpmmPlan)")
    train = plan if isinstance(plan, SpmmTrainPlan) else None
    if train is not None:
        plan = train.fwd
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
        if isinstance(plan, PartitionedSpmmPlan):
            # order names shard-local slots; the global capacity bound
            # lives on the payload gather map
            if plan.gather_live.any() and int(
                    plan.gather[plan.gather_live].max()) >= a.n_blocks_max:
                raise ValueError("plan gathers blocks beyond the operand's "
                                 "capacity — was it built for this weight?")
        elif plan.order.size and int(plan.order.max()) >= a.n_blocks_max:
            raise ValueError("plan indexes blocks beyond the operand's "
                             "capacity — was it built for this weight?")
        if (plan.block_m, plan.block_k) != a.block_shape:
            raise ValueError(
                f"plan was built for blocks "
                f"({plan.block_m}, {plan.block_k}), operand blocks are "
                f"{a.block_shape} — was it built for this weight?")
    if plan is None and schedule == "partitioned":
        col = n_col_shards if n_col_shards is not None else 1
        shards = n_shards if n_shards is not None \
            else max(len(local_devices()) // col, 1)
        plan = plan_partitioned_spmm(a, n_shards=shards, n_lanes=n_lanes,
                                     chunk=chunk, n_col_shards=col)
    if plan is None and schedule != "naive":
        plan = plan_spmm(a, n_lanes=n_lanes, chunk=chunk,
                         row_atomic=(schedule == "row_atomic"))
    if train is not None:
        train_thunk = lambda: train
    elif isinstance(plan, PartitionedSpmmPlan):
        memo = []

        def train_thunk(fwd=plan):
            if not memo:
                memo.append(plan_partitioned_spmm_vjp(
                    a, n_shards=fwd.n_shards, n_lanes=n_lanes, chunk=chunk,
                    fwd=fwd))
            return memo[0]
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
            # block, and run the transpose-side plan in its layout (a
            # partitioned one gathers per shard: on a mesh card, once per
            # payload version)
            transposed = (d["t_perm"], train.n_blocks_max)
            if isinstance(train.bwd, PartitionedSpmmPlan):
                db = _partitioned_spmm_f32(blocks, dc, train.bwd, bn=ctx.bn,
                                           transposed=transposed)
            else:
                db = _planned_spmm_f32(transpose_payload(blocks, *transposed),
                                       dc, train.bwd, bn=ctx.bn)
            db = db.to(b3.dtype)
        if need_da:
            # dA = (dC·Bᵀ) sampled at A's pattern; pads masked in-kernel
            # and again here, as the reference does
            if isinstance(train.fwd, PartitionedSpmmPlan):
                da = _partitioned_sddmm_f32(dc, b3, train, bn=ctx.bn)
            else:
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


def _planned_spmm_f32(blocks, b3, plan, *, bn: int) -> torch.Tensor:
    """Planned SpMM → merged ``(G, M, N)`` f32 (the cast is the caller's),
    in the layout the plan carries, on every device: ``"rmw"`` runs B4,
    which sums each row's runs in lane order; ``"compact"`` runs B1 into
    per-run slots and merges them in slot order.  The two agree bit for
    bit on one plan.  (The reference runs rmw only interpreted: Mosaic
    cannot re-read a revisited output tile, so its compiled calls take
    compact.)  A :class:`PartitionedSpmmPlan` runs
    :func:`_partitioned_spmm_f32`."""
    if isinstance(plan, PartitionedSpmmPlan):
        return _partitioned_spmm_f32(blocks, b3, plan, bn=bn)
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
# mesh-partitioned execution: B1 and B2 per shard, the row-offset merge
# --------------------------------------------------------------------------

def _mesh_for(n_shards: int, n_col: int, *operands: torch.Tensor):
    """``partition_mesh``'s mesh for a plan run on ``operands``.  A mesh
    device of another type than the operands' raises: card tensors never
    send a shard's work to the CPU (nor CPU tensors to a card)."""
    mesh, _ = partition_mesh(n_shards, n_col)
    if mesh is not None:
        mesh.check_operands(*operands)
    return mesh


def _col_panels(n: int, n_col: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` columns of each of ``n_col`` panels of N:
    contiguous, in order, as even as they go."""
    return [(n * c // n_col, n * (c + 1) // n_col) for c in range(n_col)]


def _panel(x: torch.Tensor, lo: int, hi: int, n_col: int,
           device: torch.device) -> torch.Tensor:
    """Columns ``[lo, hi)`` of ``x`` on ``device``, contiguous; the whole
    of ``x`` (no copy on its own device) when N is not split."""
    x = x if n_col == 1 else x[..., lo:hi]
    return x.to(device).contiguous()


def _shard_payload(blocks, plan: PartitionedSpmmPlan, d: int,
                   device: torch.device, transposed=None) -> torch.Tensor:
    """Shard ``d``'s own blocks on a mesh ``device`` that does not hold
    the payload: its live local slots, in local order (with
    ``transposed = (t_perm, cap)``, the dB side's: Aᵀ's blocks, gathered
    from A's payload ``blocks`` and each swapped).  Copied once per
    payload version and kept with the plan's tensors on ``device``, keyed
    weakly by the payload tensor, so the mesh card does not receive the
    weight on every call; a payload changed in place (an optimizer step)
    is copied again at its next call."""
    cache = plan.on_device(device)["shards"][d].setdefault(
        "payload", WeakIdKeyDictionary())
    hit = cache.get(blocks)
    if hit is not None and hit[0] == blocks._version:
        return hit[1]
    own = plan.on_device(blocks.device)["shards"][d]["own"]
    if transposed is None:
        part = blocks.index_select(0, own)
    else:
        part = blocks.index_select(
            0, transposed[0].index_select(0, own)).transpose(1, 2)
    part = part.to(device).contiguous()
    cache[blocks] = (blocks._version, part)
    return part


def _partitioned_tiles(blocks, b3, plan: PartitionedSpmmPlan, *, bn: int,
                       transposed=None) -> torch.Tensor:
    """Every shard's B1 (:func:`maple_spmm_compact`) on its own compact
    plan into its slots of one stacked slot buffer ``(G, n_slots, bm, N)``
    (``plan.slot_offsets``), once per column panel of N
    (``plan.n_col_shards``; the panels' buffers concatenate along N).
    With ``transposed = (t_perm, cap)`` the operand is Aᵀ, whose payload
    is A's ``blocks`` gathered by ``t_perm`` and swapped
    (:func:`transpose_payload`, as the single-device dB gathers it).

    ``partition_mesh`` places the work: on a mesh, shard ``d``'s panel
    ``c`` runs on the mesh's ``(d, c)`` device; without one (fewer cards
    than the plan's shards) the same calls run one after another on B's
    device.  On the payload's own device B1 reads the payload through the
    shard's global-slot order and writes its slots in place; a mesh
    device elsewhere takes the shard's own blocks (:func:`_shard_payload`)
    and B's panel, and its slots come back into the buffer.  Both run the
    same kernel on the same operands, so the bits agree.  A kernel's
    failure raises."""
    mesh = _mesh_for(plan.n_shards, plan.n_col_shards, blocks, b3)
    home = b3.device
    g, n = b3.shape[0], b3.shape[-1]
    n_col = plan.n_col_shards
    payload = None if transposed is not None else blocks
    bufs = []
    for c, (lo, hi) in enumerate(_col_panels(n, n_col)):
        buf = torch.empty((g, plan.n_slots * plan.block_m, hi - lo),
                          dtype=torch.float32, device=home)
        bb = _panel(b3, lo, hi, n_col, home)
        for d in range(plan.n_shards):
            dev = home if mesh is None else mesh.device(d, c)
            sd = plan.on_device(dev)["shards"][d]
            if mesh is not None:        # the shard's slots, gathered
                shard = plan.shards[d]
                record_collective("all-gather", 4 * g * (hi - lo)
                                  * shard.n_lanes * shard.r_max
                                  * plan.block_m)
            if dev == home == blocks.device:
                if payload is None:
                    payload = transpose_payload(blocks, *transposed)
                maple_spmm_compact(payload, sd["order"], sd["step_col"],
                                   sd["stacked_runs"], bb,
                                   n_slots=plan.n_slots, bn=bn, out=buf)
                continue
            p = plan.shards[d]
            with _build.on(dev):
                part = maple_spmm_compact(
                    _shard_payload(blocks, plan, d, dev, transposed),
                    sd["local_order"], sd["step_col"], sd["runs"],
                    bb.to(dev).contiguous(), n_slots=p.n_lanes * p.r_max,
                    bn=bn)
            s0 = plan.slot_offsets[d] * plan.block_m
            buf[:, s0:s0 + part.shape[1]].copy_(part)
        bufs.append(buf)
    tiles = bufs[0] if n_col == 1 else torch.cat(bufs, -1)
    return tiles.view(g, plan.n_slots, plan.block_m, n)


def _partitioned_spmm_f32(blocks, b3, plan: PartitionedSpmmPlan, *,
                          bn: int, transposed=None) -> torch.Tensor:
    """Mesh-partitioned planned SpMM → merged ``(G, M, N)`` f32 (the
    reference's ``_partitioned_spmm_f32``): B1 per shard
    (:func:`_partitioned_tiles`), then the row-offset merge
    (:func:`_scatter_merge_f32` over ``plan.merge_ranks``), which adds
    every slot into its row in f32 in the stacked ``(shard, lane, slot)``
    order: no atomics, a split row sums its partials in one fixed order,
    and the result rounds once (the caller's cast)."""
    tiles = _partitioned_tiles(blocks, b3, plan, bn=bn,
                               transposed=transposed)
    return _scatter_merge_f32(tiles, plan.on_device(b3.device)["merge"],
                              gm=plan.n_block_rows)


def _sddmm_shards_on(train: SpmmTrainPlan, device: torch.device) -> list:
    """Per shard of a partitioned train plan's forward: the block rows and
    columns of its local slots (``sddmm_shard_meta``: dead slots at row 0,
    column -1) and the global slots of its live ones, on ``device``,
    built once per device.  Each shard's live slots must come first: the
    placement in :func:`_partitioned_sddmm_f32` relies on it."""
    key = ("sddmm_shards", str(device))
    cached = train._on_device.get(key)
    if cached is None:
        fwd = train.fwd
        if (np.diff(fwd.gather_live.astype(np.int8), axis=1) > 0).any():
            raise ValueError("a shard of the plan has a pad slot before a "
                             "live one: its live slots must come first")
        sd_row, sd_col = sddmm_shard_meta(fwd.gather, fwd.gather_live,
                                          train.block_row, train.block_col)
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        cached = [(as_t(sd_row[d]), as_t(sd_col[d]),
                   as_t(fwd.gather[d][fwd.gather_live[d]].astype(np.int64)))
                  for d in range(fwd.n_shards)]
        train._on_device[key] = cached
    return cached


def _partitioned_sddmm_f32(dc, b3, train: SpmmTrainPlan, *,
                           bn: int) -> torch.Tensor:
    """Mesh-partitioned dA → ``(n_blocks_max, bm, bk)`` f32 (the
    reference's ``_partitioned_sddmm_f32``).

    dA ownership follows the forward plan's ``gather``: each shard runs
    B2 (:func:`maple_sddmm_bsr`) over its local slots, reading the dC rows
    it owns.  N is the SDDMM's contraction axis, so with column panels
    each panel gives a partial and the partials add in panel order (the
    reference's ``psum`` over ``COL_AXIS``; here the same order on the
    mesh and in the loop).  The shards' live slots are disjoint and come
    first in each shard, so the merge back to A's slots is an
    ``index_copy`` of each shard's live prefix into zeros: placement, no
    ``+ 0.0`` on a live value.  Mesh placement as in
    :func:`_partitioned_tiles`; only dC and B go to a mesh device."""
    fwd = train.fwd
    bm, bk = train.block_shape
    mesh = _mesh_for(fwd.n_shards, fwd.n_col_shards, dc, b3)
    home = dc.device
    n_col = fwd.n_col_shards
    panels = _col_panels(dc.shape[-1], n_col)
    da = torch.zeros((train.n_blocks_max, bm, bk), dtype=torch.float32,
                     device=home)
    for d, (_, _, own) in enumerate(_sddmm_shards_on(train, home)):
        acc = None
        for c, (lo, hi) in enumerate(panels):
            if hi == lo:
                continue                  # N < n_col: an empty panel adds 0
            dev = home if mesh is None else mesh.device(d, c)
            with _build.on(dev):
                row, col, _ = _sddmm_shards_on(train, dev)[d]
                part = maple_sddmm_bsr(
                    _panel(dc, lo, hi, n_col, dev),
                    _panel(b3, lo, hi, n_col, dev), row, col, bm=bm, bk=bk,
                    bn=bn).to(home)
            if mesh is not None and n_col > 1:    # the psum over COL_AXIS
                record_collective("all-reduce",
                                  part.numel() * part.element_size())
            acc = part if acc is None else acc + part
        if acc is not None:               # N = 0: dA is 0
            if mesh is not None:          # the shard's dA, gathered
                record_collective("all-gather", own.numel() * bm * bk * 4)
            da.index_copy_(0, own, acc[:own.numel()])
    return da


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
    Forward only, as the reference's: raises under a gradient of
    ``x_sorted`` or ``w`` (the MoE layer trains through
    :func:`~repro_torch.kernels.moe_gemm.moe_gemm`'s own backward).
    """
    if torch.is_grad_enabled() and (x_sorted.requires_grad
                                    or w.requires_grad):
        raise NotImplementedError(
            "moe_expert_gemm has no gradient, as the reference's entry "
            "point: the MoE layer trains through moe_gemm's backward")
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
    kernel launch covers the whole batch.  Forward only: raises under a
    gradient of q, k or v (local attention's backward is not ported yet).
    """
    kv_map = torch.from_numpy(local_window_kv_map(q.shape[1], window, bq,
                                                  bk)).to(q.device)
    return block_attention(q, k, v, kv_map, bq=bq, bk=bk, causal=True,
                           window=window)
