"""Maple SpMM kernel wrappers: block-CSR ``A`` × dense ``B`` on Hopper.

Three kernels (CUDA C++, ``csrc/maple_spmm.cu``), each with a plain
PyTorch version of the same function beside it:

* :func:`maple_spmm_naive` — replaces ``maple_spmm_batched_pallas``
  (``repro/kernels/maple_spmm.py``): the naive walk, one f32 PSB per
  block-row, flushed once in the input type; empty block-rows come out 0.
* :func:`maple_spmm_compact` — replaces ``maple_spmm_compact_pallas``:
  the planned walk, one f32 PSB per (lane, row) run of the plan, flushed
  into the run's compact slot; returns the f32 slot buffer, whose dead
  slots are left unwritten (undefined).
* :func:`maple_spmm_planned` — replaces ``maple_spmm_planned_pallas``:
  the same runs, summed per block-row in lane order into the merged f32
  ``(G, M, N)`` result (the rmw layout); rows no run names come out 0.
  On one plan it equals :func:`maple_spmm_compact` plus
  ``ops._scatter_merge_f32`` bit for bit.

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; each launch adds one to the
wrapper's ``launches`` count.  Inputs are f32 or bf16 (both operands
alike), accumulated in f32.  The kernel masks a ragged ``N`` itself, so
no padded copy of ``B`` is made; ``bn`` is the widest N tile of a
thread block (narrowed to the next power of two ≥ 16 above ``N``).

All three share one run walk on the card (``csrc/maple_spmm.cu``): a
cluster of :data:`SEGMENTS` thread blocks per (run, N tile, batch), block
j walking the run's segment j (:func:`run_segments`), the run's PSB
``(p₀ + p₁) + (p₂ + p₃)``; B3's runs are its block-rows.
:func:`run_layout` and :func:`naive_route` are the host's side of a
launch: the consumer, the N tile, the tile count, the floats of one
partial (which size B4's scratch buffer), and for B3 how batches fold
and how B's panels are copied.
"""

from __future__ import annotations

import functools
import types

import torch

from repro_torch.kernels import _build
from repro_torch.regions import region

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_operands(blocks, b3, ints, bn):
    if blocks.dim() != 3 or b3.dim() != 3:
        raise ValueError(f"blocks must be (nb, bm, bk) and B (G, K, N); got "
                         f"{tuple(blocks.shape)} and {tuple(b3.shape)}")
    if blocks.dtype not in _DTYPES or b3.dtype != blocks.dtype:
        raise TypeError(f"blocks and B must both be float32 or bfloat16, got "
                        f"{blocks.dtype} and {b3.dtype}")
    if b3.shape[1] % blocks.shape[2]:
        raise ValueError(f"K={b3.shape[1]} not divisible by block k="
                         f"{blocks.shape[2]}")
    for name, t in (("blocks", blocks), ("B", b3), *ints):
        if t.device != b3.device:
            raise ValueError(f"{name} is on {t.device}, B on {b3.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if b3.is_cuda:
        if bn < 16 or bn > 256 or bn & (bn - 1):
            raise ValueError(f"bn={bn}: the CUDA kernels take a power-of-two "
                             f"N tile in [16, 256]")
        if blocks.shape[2] % 4 or blocks.data_ptr() % 16:
            raise ValueError("the CUDA kernels read blocks 4 elements at a "
                             "time: block k must be a multiple of 4 and the "
                             "payload 16-byte aligned")


def _tile_n(bn: int, n: int) -> int:
    return min(bn, max(16, 1 << max(n - 1, 0).bit_length()))


# --------------------------------------------------------------------------
# the run walk of B1, B3 and B4: the host's half
# --------------------------------------------------------------------------

SEGMENTS = 4                    # blocks of a cluster = segments of a run
CONSUMERS = 128                 # consumer threads of a block
_FFMA_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (1, 4), (1, 2), (1, 1))


def run_segments(first: int, end: int) -> list:
    """The steps ``[lo, hi)`` of each of a run's :data:`SEGMENTS`
    segments: contiguous, in order, covering ``[first, end)``; block j of
    the run's cluster walks segment j, and the run's PSB is
    ``(p₀ + p₁) + (p₂ + p₃)`` over their partials."""
    n = end - first
    return [(first + n * j // SEGMENTS, first + n * (j + 1) // SEGMENTS)
            for j in range(SEGMENTS)]


def ffma_tile(bm: int, tile: int):
    """The FFMA consumer's register tile ``(TM, TN)`` for a ``(bm, tile)``
    output tile: the one that sets the most of the 128 consumer threads to
    work (the larger tile on a tie); ``None`` when none fits."""
    best, best_threads = None, 0
    for tm, tn in _FFMA_TILES:
        if bm % tm or tile % tn:
            continue
        threads = (bm // tm) * (tile // tn)
        if best_threads < threads <= CONSUMERS:
            best, best_threads = (tm, tn), threads
    return best


def run_layout(dtype: torch.dtype, n: int, bm: int, bk: int,
               bn: int) -> dict:
    """What a B1 / B4 launch on the card takes from the shapes: the
    consumer — ``"wgmma"`` for bf16 at 64 × 64 blocks (8 columns for
    N ≤ 8, else 64 or 128), ``"skinny"`` for N ≤ 4 (one row a thread, 4
    columns), else ``"ffma"`` with the register tile of :func:`ffma_tile` —
    its N tile (at most 128 columns), the number of N tiles and the floats
    of one partial (128 threads × the registers of one tile), which size
    B4's scratch: ``G · n_tiles · n_runs · frag``."""
    tile = min(_tile_n(bn, n), 128)
    if dtype == torch.bfloat16 and bm == 64 and bk == 64:
        tile = 8 if n <= 8 else 64 if tile <= 64 else 128
        consumer, regs = "wgmma", tile // 2
    elif n <= 4 and bm <= CONSUMERS:
        tile, consumer, regs = 4, "skinny", 4
    else:
        tiles = ffma_tile(bm, tile)
        if tiles is None:
            raise ValueError(f"no FFMA register tile fits a ({bm}, {tile}) "
                             f"output tile")
        consumer, regs = "ffma", tiles[0] * tiles[1]
    return {"consumer": consumer, "tile": tile,
            "n_tiles": -(-n // tile), "frag": regs * CONSUMERS}


def walk_tile(dtype: torch.dtype, n: int, bm: int, bk: int, bn: int, *,
              runs: int, g: int, sms: int) -> int:
    """The N tile a B1 / B4 launch over ``runs`` runs asks for: ``bn``
    narrowed to N (at most 128), then halved (down to 64 for wgmma, 32 for
    the FFMA tile) while the grid — :data:`SEGMENTS` blocks a run, tile
    and batch — would give fewer than 4 blocks for each of the ``sms``
    SMs: a 40-row MLP plan at N = 256 fills 328 blocks with 128 columns,
    656 with 64."""
    tile = min(_tile_n(bn, n), 128)
    floor = 64 if dtype == torch.bfloat16 and (bm, bk) == (64, 64) else 32
    while tile > floor and runs * SEGMENTS * g * -(-n // tile) < 4 * sms:
        tile //= 2
    return tile


def ring_stages(order_numel: int, runs: int) -> int:
    """Stages of a block's ring: 4 where a segment averages more than 16
    steps (the plan's ``L · steps`` slots over its runs and
    :data:`SEGMENTS`; long bytes-bound walks keep more loads in flight),
    else 2, which lets more blocks share an SM: the MLP's plans (2.5 to
    9.5 steps a segment) and the head at decode (5)."""
    return 4 if order_numel > 16 * SEGMENTS * max(runs, 1) else 2


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    count = _SMS.get(str(device))
    if count is None:
        count = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[str(device)] = count
    return count


def _check_run_operands(blocks: torch.Tensor) -> None:
    if blocks.is_cuda and (blocks.shape[1] * blocks.shape[2]
                           * blocks.element_size()) % 16:
        raise ValueError("the run walk copies whole weight blocks: "
                         "bm·bk·size must be a multiple of 16 bytes")


# BMode of csrc/maple_spmm.cu: 3 is B3's folded (G, K) box at N = 1
_COPIES = ("tma", "bulk", "producer", "tma")


@functools.lru_cache(maxsize=256)
def naive_route(dtype: torch.dtype, g: int, gm: int, n: int, k: int,
                bm: int, bk: int, bn: int, *, n_slots: int, sms: int,
                aligned: bool = True) -> types.MappingProxyType:
    """How a B3 launch runs on the card (``plan_naive`` in
    ``csrc/maple_spmm.cu``).  Each of the ``gm`` block-rows is one run.
    The N tile is :func:`walk_tile`'s over ``gm`` runs, and
    :func:`run_layout` picks the consumer.  On the skinny tile and on
    wgmma's n8 tile the batches fold: a cluster takes ``fold = tile // n``
    of them side by side (column c is batch c // n, column c % n), in
    ``groups = ceil(g / fold)`` clusters a row, so each weight block is read
    once a group; each batch's panel comes by its own bulk copy where
    every panel is 16-byte aligned, else the producer warp copies it.
    At N = 1 the fold has its own layouts: bf16 on wgmma's n8 tile takes
    8 batches' panels as one TMA box over B viewed as ``(G, K)`` (K-major,
    swizzled: nothing to lay out), where K·size is a multiple of 16
    bytes; the skinny tile splits its 4 columns over the 4 consumer warps
    (``"split"``), and folds only where ``bm <= 64``.
    Elsewhere ``fold`` is 0 and each batch has its own clusters
    (``groups = g``), B's panel by TMA, one bulk copy or the producer.
    ``stages`` caps the ring: 4 where the grid gives at most 2 CTAs an SM
    (decode: 160), else :func:`ring_stages` over the slots.  Cached: the
    serving path asks once a layer a step, with the same shapes; the
    mapping is read-only, since every caller shares it."""
    tile = walk_tile(dtype, n, bm, bk, bn, runs=gm, g=g, sms=sms)
    lay = run_layout(dtype, n, bm, bk, tile)
    isz = 2 if dtype == torch.bfloat16 else 4
    consumer = lay["consumer"]
    split = False
    if (consumer == "skinny" and (n > 1 or bm <= 64)) or (
            consumer == "wgmma" and lay["tile"] == 8):
        fold = lay["tile"] // n
        groups = -(-g // fold)
        copy = ("bulk" if aligned and (bk * n * isz) % 16 == 0
                and (k * n * isz) % 16 == 0 else "producer")
        if consumer == "wgmma" and n == 1 and aligned and (k * isz) % 16 == 0:
            copy = "tma"
        split = consumer == "skinny" and n == 1 and bm <= 64
    else:
        fold, groups = 0, g
        if aligned and (n * isz) % 16 == 0 and bk <= 256:
            copy = "tma"
        elif (aligned and n <= lay["tile"] and (bk * n * isz) % 16 == 0
              and (consumer != "wgmma" or lay["tile"] == 8)):
            copy = "bulk"
        else:
            copy = "producer"
    ctas = SEGMENTS * gm * groups * lay["n_tiles"]
    stages = 4 if ctas <= 2 * sms else ring_stages(n_slots, gm)
    return types.MappingProxyType({
        **lay, "bn": tile, "fold": fold, "groups": groups, "copy": copy,
        "split": split, "ctas": ctas, "stages": stages})


_COUNTERS: dict = {}
_OUTGROWN: list = []


def _row_counters(device: torch.device, n: int) -> torch.Tensor:
    """B4's per-(batch, tile, row, quarter) arrival counters, zero between
    launches (the last run of a split row resets its counter), kept per
    device: B4 launches that share them run one after another on one
    stream.  A CUDA graph replays the address of the counters it was
    captured with, so counters a larger launch outgrows are kept, never
    freed; and they are allocated (and zeroed) outside any capture, by a
    step's eager warm-up."""
    have = _COUNTERS.get(str(device))
    if have is None or have.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"B4 needs {n} arrival counters on {device}, more than it "
                f"holds, inside a CUDA graph capture: run the step once "
                f"eagerly first")
        if have is not None:
            _OUTGROWN.append(have)
        have = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[str(device)] = have
    return have


# --------------------------------------------------------------------------
# naive schedule (B3)
# --------------------------------------------------------------------------

@region
def maple_spmm_naive(blocks: torch.Tensor, row_ptr: torch.Tensor,
                     block_col: torch.Tensor, b3: torch.Tensor, *,
                     bn: int = 128) -> torch.Tensor:
    """``(G, gm·bm, N)`` in B's dtype: block-row ``i`` of every batch ``g``
    is the f32 sum over slots ``row_ptr[i] .. row_ptr[i+1]`` (pads with
    ``block_col < 0`` masked) of ``blocks[s] @ B[g, col·bk : (col+1)·bk]``,
    cast once.  On the card each block-row is one run of the run walk
    (:func:`naive_route`), summed ``(p₀ + p₁) + (p₂ + p₃)``."""
    _check_operands(blocks, b3, (("row_ptr", row_ptr),
                                 ("block_col", block_col)), bn)
    _check_run_operands(blocks)
    if b3.is_meta:
        return b3.new_empty((b3.shape[0], (row_ptr.numel() - 1)
                             * blocks.shape[1], b3.shape[2]))
    if not b3.is_cuda:
        return maple_spmm_naive_plain(blocks, row_ptr, block_col, b3)
    nb, bm, bk = blocks.shape
    g, k, n = b3.shape
    gm = row_ptr.numel() - 1
    out = torch.empty((g, gm * bm, n), dtype=b3.dtype, device=b3.device)
    if out.numel() == 0:
        return out
    route = naive_route(b3.dtype, g, gm, n, k, bm, bk, bn,
                        n_slots=block_col.numel(), sms=_sm_count(b3.device),
                        aligned=b3.data_ptr() % 16 == 0)
    lib = _build.library("maple_spmm")
    err = _build.launch(
        lib.maple_spmm_naive, b3.device,
        blocks.data_ptr(), row_ptr.data_ptr(), block_col.data_ptr(),
        b3.data_ptr(), out.data_ptr(), _DTYPES[b3.dtype], g, nb, gm, k, n, bm,
        bk, route["bn"], route["stages"])
    _build.check(lib, err, "maple_spmm_naive")
    maple_spmm_naive.launches += 1
    return out


maple_spmm_naive.launches = 0


def maple_spmm_naive_plain(blocks, row_ptr, block_col, b3) -> torch.Tensor:
    """Plain PyTorch version of :func:`maple_spmm_naive`."""
    nb, bm, bk = blocks.shape
    g, k, n = b3.shape
    gm = row_ptr.numel() - 1
    nnzb = int(row_ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(gm, device=b3.device),
        (row_ptr[1:] - row_ptr[:-1]).long())
    cols = block_col[:nnzb].long()
    live = cols >= 0
    out = torch.zeros((g, gm, bm, n), dtype=torch.float32, device=b3.device)
    panels = b3.float().reshape(g, k // bk, bk, n)[:, cols[live]]
    contrib = torch.einsum("sik,gskn->gsin",
                           blocks[:nnzb][live].float(), panels)
    out.index_add_(1, rows[live], contrib)
    return out.reshape(g, gm * bm, n).to(b3.dtype)


# --------------------------------------------------------------------------
# planned compact layout (B1)
# --------------------------------------------------------------------------

@region
def maple_spmm_compact(blocks: torch.Tensor, order: torch.Tensor,
                       step_col: torch.Tensor, runs: torch.Tensor,
                       b3: torch.Tensor, *, n_slots: int, bn: int = 128,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """The f32 compact slot buffer ``(G, n_slots·bm, N)``: for each run
    ``(lane, first, end, slot)`` of the plan's run table, slot ``slot``
    holds the f32 sum over steps ``first .. end`` of lane ``lane`` (pad
    steps with ``step_col < 0`` add nothing) of
    ``blocks[order] @ B[g, step_col·bk : (step_col+1)·bk]``.  Slots no run
    names are not written: given ``out`` (contiguous f32 of that shape
    on B's device), the runs write their slots of it and leave the rest
    as they were, so several run tables can fill one buffer (the
    partitioned executor's shards)."""
    _check_operands(blocks, b3, (("order", order), ("step_col", step_col),
                                 ("runs", runs)), bn)
    if order.shape != step_col.shape or order.dim() != 2:
        raise ValueError("order and step_col must be one (lanes, steps) shape")
    if runs.dim() != 2 or runs.shape[1] != 4:
        raise ValueError(f"runs must be (n_runs, 4), got {tuple(runs.shape)}")
    _check_run_operands(blocks)
    nb, bm, bk = blocks.shape
    g, k, n = b3.shape
    if out is not None and (
            out.shape != (g, n_slots * bm, n) or out.dtype != torch.float32
            or out.device != b3.device or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous float32 "
                         f"{(g, n_slots * bm, n)} on {b3.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if b3.is_meta:
        return out if out is not None else b3.new_empty(
            (g, n_slots * bm, n), dtype=torch.float32)
    if not b3.is_cuda:
        return maple_spmm_compact_plain(blocks, order, step_col, runs, b3,
                                        n_slots=n_slots, out=out)
    if out is None:
        out = torch.empty((g, n_slots * bm, n), dtype=torch.float32,
                          device=b3.device)
    if out.numel() == 0 or runs.shape[0] == 0:
        return out                      # no run: every slot is dead
    tile = walk_tile(b3.dtype, n, bm, bk, bn, runs=runs.shape[0], g=g,
                     sms=_sm_count(b3.device))
    lib = _build.library("maple_spmm")
    err = _build.launch(
        lib.maple_spmm_compact, b3.device,
        blocks.data_ptr(), order.data_ptr(), step_col.data_ptr(),
        runs.data_ptr(), b3.data_ptr(), out.data_ptr(), _DTYPES[b3.dtype], g,
        nb, runs.shape[0], order.shape[1], n_slots, k, n, bm, bk, tile,
        ring_stages(order.numel(), runs.shape[0]))
    _build.check(lib, err, "maple_spmm_compact")
    maple_spmm_compact.launches += 1
    return out


maple_spmm_compact.launches = 0


def _run_psbs(blocks, order, step_col, runs, b3) -> torch.Tensor:
    """``(G, n_runs, bm, N)`` f32: run r's PSB, the sum over its steps in
    step order (pad steps add nothing).  Shared by the plain versions."""
    nb, bm, bk = blocks.shape
    g, k, n = b3.shape
    steps = order.shape[1]
    runs = runs.long()
    lane, first, end, _ = runs.unbind(1)
    length = end - first
    run_of = torch.repeat_interleave(torch.arange(runs.shape[0],
                                                  device=b3.device), length)
    start_of = torch.repeat_interleave(torch.cumsum(length, 0) - length,
                                       length)
    s = first[run_of] + torch.arange(run_of.numel(), device=b3.device) \
        - start_of
    flat = lane[run_of] * steps + s
    cols = step_col.reshape(-1)[flat].long()
    live = cols >= 0
    blk = order.reshape(-1)[flat][live].long()
    psbs = torch.zeros((g, runs.shape[0], bm, n), dtype=torch.float32,
                       device=b3.device)
    panels = b3.float().reshape(g, k // bk, bk, n)[:, cols[live]]
    contrib = torch.einsum("sik,gskn->gsin", blocks[blk].float(), panels)
    return psbs.index_add_(1, run_of[live], contrib)


def maple_spmm_compact_plain(blocks, order, step_col, runs, b3, *,
                             n_slots: int, out=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`maple_spmm_compact`.  Slots no run
    names hold NaN (or, given ``out``, what they held), so a merge that
    reads one shows it."""
    g, n = b3.shape[0], b3.shape[2]
    if out is None:
        out = torch.full((g, n_slots * blocks.shape[1], n), float("nan"),
                         dtype=torch.float32, device=b3.device)
    out.view(g, n_slots, blocks.shape[1], n)[:, runs[:, 3].long()] = \
        _run_psbs(blocks, order, step_col, runs, b3)
    return out


# --------------------------------------------------------------------------
# planned rmw layout (B4)
# --------------------------------------------------------------------------

@region
def maple_spmm_planned(blocks: torch.Tensor, order: torch.Tensor,
                       step_col: torch.Tensor, row_runs: torch.Tensor,
                       row_run_ptr: torch.Tensor, b3: torch.Tensor, *,
                       bn: int = 128) -> torch.Tensor:
    """The merged f32 result ``(G, gm·bm, N)``: block-row ``i`` is
    ``((0 + P₀) + P₁) + ...`` over its runs ``row_runs[row_run_ptr[i] :
    row_run_ptr[i + 1]]`` in that (lane) order, where a run's PSB ``P``
    is the f32 sum over steps ``first .. end`` of lane ``lane`` (pad steps
    add nothing) of ``blocks[order] @ B[g, step_col·bk : (step_col+1)·bk]``.
    A row with no run is 0."""
    _check_operands(blocks, b3, (("order", order), ("step_col", step_col),
                                 ("row_runs", row_runs),
                                 ("row_run_ptr", row_run_ptr)), bn)
    if order.shape != step_col.shape or order.dim() != 2:
        raise ValueError("order and step_col must be one (lanes, steps) shape")
    if row_runs.dim() != 2 or row_runs.shape[1] != 4:
        raise ValueError(f"row_runs must be (n_runs, 4), got "
                         f"{tuple(row_runs.shape)}")
    if row_run_ptr.dim() != 1 or row_run_ptr.numel() < 1:
        raise ValueError("row_run_ptr must be (gm + 1,)")
    _check_run_operands(blocks)
    if b3.is_meta:
        return b3.new_empty((b3.shape[0], (row_run_ptr.numel() - 1)
                             * blocks.shape[1], b3.shape[2]),
                            dtype=torch.float32)
    if not b3.is_cuda:
        return maple_spmm_planned_plain(blocks, order, step_col, row_runs,
                                        row_run_ptr, b3)
    nb, bm, bk = blocks.shape
    g, k, n = b3.shape
    gm = row_run_ptr.numel() - 1
    out = torch.empty((g, gm * bm, n), dtype=torch.float32, device=b3.device)
    if out.numel() == 0:
        return out
    n_runs = row_runs.shape[0]
    tile = walk_tile(b3.dtype, n, bm, bk, bn, runs=max(n_runs, 1), g=g,
                     sms=_sm_count(b3.device))
    lay = run_layout(b3.dtype, n, bm, bk, tile)
    scratch = torch.empty(g * lay["n_tiles"] * n_runs * lay["frag"],
                          dtype=torch.float32, device=b3.device)
    counters = _row_counters(b3.device, g * lay["n_tiles"] * gm * SEGMENTS)
    lib = _build.library("maple_spmm")
    err = _build.launch(
        lib.maple_spmm_planned, b3.device,
        blocks.data_ptr(), order.data_ptr(), step_col.data_ptr(),
        row_runs.data_ptr(), row_run_ptr.data_ptr(), b3.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
        _DTYPES[b3.dtype], g, nb, gm, n_runs, order.shape[1], k, n, bm, bk,
        tile, ring_stages(order.numel(), n_runs))
    _build.check(lib, err, "maple_spmm_planned")
    maple_spmm_planned.launches += 1
    return out


maple_spmm_planned.launches = 0


def maple_spmm_planned_plain(blocks, order, step_col, row_runs, row_run_ptr,
                             b3) -> torch.Tensor:
    """Plain PyTorch version of :func:`maple_spmm_planned`: the runs' PSBs,
    then, for k = 0, 1, ..., every row's k-th run added to the row."""
    g, n = b3.shape[0], b3.shape[2]
    bm = blocks.shape[1]
    gm = row_run_ptr.numel() - 1
    psbs = _run_psbs(blocks, order, step_col, row_runs, b3)
    ptr = row_run_ptr.long()
    count = ptr[1:] - ptr[:-1]
    out = psbs.new_zeros((g, gm, bm, n))
    for k in range(int(count.max()) if gm else 0):
        rows = torch.nonzero(count > k)[:, 0]
        out.index_copy_(1, rows, out.index_select(1, rows)
                        + psbs.index_select(1, ptr[rows] + k))
    return out.reshape(g, gm * bm, n)
