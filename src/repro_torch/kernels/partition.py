"""Mesh-partitioned SpMM planning (port of ``repro.kernels.partition``):
shard a ``BlockCSR``'s block-rows across devices, one compact
:class:`~repro_torch.kernels.schedule.SpmmPlan` per shard.

The reference's five steps, host numpy, every array equal to its:

1. block-rows (or ``device_chunk`` pieces of heavy ones) are LPT-packed
   across ``n_shards`` devices by block count (``schedule._lpt_pack``);
2. each device's rows become a shard-local sub-pattern (global row ids,
   locally compacted block slots) planned by ``plan_spmm`` in the compact
   layout;
3. a padding-aware repack trades items between devices to lower the
   stacked geometry's ``(max steps, pad slots)``;
4. the shard plans are padded to one geometry and stacked on a leading
   device axis; ``n_col_shards`` splits the dense operand's N into column
   panels at execution time and leaves the metadata unchanged;
5. a row-offset epilogue merges each shard's compact slots into its rows
   of the output; only rows ``device_chunk`` split across devices
   (``split_rows``) take partials from more than one shard.

The port adds the tables its executor (``ops._partitioned_spmm_f32``)
reads, built once per plan: the stacked slot buffer every shard's B1
fills (:attr:`PartitionedSpmmPlan.slot_offsets`), the epilogue's
deterministic order over it (:attr:`PartitionedSpmmPlan.merge_ranks`),
and :meth:`PartitionedSpmmPlan.on_device`, whose per-shard ``order``
names A's **global** block slots (the shard's ``gather`` composed with
its plan's ``order``), so a shard's kernel reads A's own payload and no
per-shard copy of it is made.  The mesh comes from
``repro_torch.distributed.sharding.partition_mesh``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.csr import BlockCSR
from repro_torch.core.maple import (SpGEMMStats, baseline_pe_cycles,
                                    maple_pe_cycles)
from repro_torch.kernels.schedule import (SpmmPlan, _default_chunk, _lpt_pack,
                                          bsr_stats, plan_spmm,
                                          transpose_train_plan)


@dataclasses.dataclass(frozen=True)
class PartitionedSpmmPlan:
    """A stack of shard-local :class:`SpmmPlan` s plus the maps that shard
    the operand and reassemble the output (the reference's fields).

    Host numpy with a leading device axis ``D``; the stacked arrays share
    one geometry (``n_lanes`` lanes, ``steps`` steps, ``r_max`` flush
    slots, ``slot_cap`` payload slots):

    * ``gather[d, t]`` / ``gather_live[d, t]`` — the global ``a.blocks``
      slot behind shard ``d``'s local slot ``t`` (0 / False where dead;
      the live slots of a shard are a prefix);
    * ``order`` / ``step_row`` / ``step_col`` / ``flush_slot`` —
      ``(D, L, S)`` stacked lane schedules, ``order`` in shard-local
      slots, ``step_row`` in global block-rows;
    * ``slot_row[d, l, t]`` — the global block-row shard ``d``'s lane
      ``l`` flushes into compact slot ``t`` (-1 dead);
    * ``row_shard`` — ``(gm,)`` lowest owning device per block-row (-1
      empty); ``split_rows`` — rows owned by more than one device;
    * ``n_col_shards`` — the column panels of the dense operand at
      execution time (metadata is the same for every panel);
    * ``shard_steps`` / ``shard_r_max`` — each shard's geometry before
      the pad to the heaviest shard.

    ``shards`` keeps the unpadded per-shard plans.  The executor runs each
    shard's own plan (its pad steps add nothing, so the stacked pad is
    never walked).
    """

    shards: Tuple[SpmmPlan, ...]
    gather: np.ndarray        # (D, slot_cap) int32
    gather_live: np.ndarray   # (D, slot_cap) bool
    order: np.ndarray         # (D, L, S) int32, shard-local slots
    step_row: np.ndarray      # (D, L, S) int32, global block-rows
    step_col: np.ndarray      # (D, L, S) int32, -1 pads
    flush_slot: np.ndarray    # (D, L, S) int32
    slot_row: np.ndarray      # (D, L, r_max) int32, -1 dead
    row_shard: np.ndarray     # (gm,) int32, -1 empty
    split_rows: Tuple[int, ...]
    r_max: int
    n_block_rows: int
    block_m: int
    block_k: int
    stats: SpGEMMStats
    n_col_shards: int = 1
    shard_steps: Tuple[int, ...] = ()
    shard_r_max: Tuple[int, ...] = ()
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    # shard outputs are disjoint per-device slot tiles: the rmw layout's
    # shared output rows cannot cross devices
    fused: str = dataclasses.field(default="compact", init=False)

    @property
    def n_shards(self) -> int:
        return self.gather.shape[0]

    @property
    def n_lanes(self) -> int:
        return self.order.shape[1]

    @property
    def steps(self) -> int:
        return self.order.shape[2]

    @property
    def slot_cap(self) -> int:
        return self.gather.shape[1]

    @property
    def padding_waste(self) -> float:
        """Fraction of the stacked ``(lane, step)`` slots that exist only
        because every shard is padded to the heaviest shard's ``steps``."""
        smax = self.steps
        pre = self.shard_steps or tuple(p.steps for p in self.shards)
        return sum(smax - s for s in pre) / max(self.n_shards * smax, 1)

    def dense_operand_bytes(self, n_cols: int, *, g: int = 1,
                            itemsize: int = 4) -> int:
        """Bytes of the dense operand one ``(shard, col)`` device holds:
        all K rows × its N column panel."""
        k = self.stats.n_cols * self.block_k       # stats rows are blocks
        panel = -(-int(n_cols) // self.n_col_shards)
        return int(g) * k * panel * itemsize

    def per_shard_cycles(self) -> List[float]:
        """Each device's realized lane makespan."""
        return [p.predicted_cycles()["plan"] for p in self.shards]

    def predicted_cycles(self) -> Dict[str, float]:
        """``plan``: the slowest shard's makespan; ``maple``: ``n_shards``
        PEs of ``n_lanes`` MACs; ``row_atomic``: rows pinned to the whole
        lane pool (the reference's model)."""
        return {
            "plan": float(max(self.per_shard_cycles(), default=1.0)),
            "maple": maple_pe_cycles(self.stats, macs_per_pe=self.n_lanes,
                                     n_pes=self.n_shards),
            "row_atomic": baseline_pe_cycles(
                self.stats, n_pes=self.n_lanes * self.n_shards),
        }

    @functools.cached_property
    def slot_offsets(self) -> Tuple[int, ...]:
        """Where each shard's compact slots start in the stacked slot
        buffer the executor fills (shard d's ``n_lanes · r_max`` slots at
        ``slot_offsets[d]``); the last entry is the buffer's slot count."""
        sizes = [p.n_lanes * p.r_max for p in self.shards]
        return tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)]))

    @functools.cached_property
    def n_slots(self) -> int:
        """Slots of the stacked slot buffer."""
        return self.slot_offsets[-1]

    @functools.cached_property
    def merge_ranks(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The row-offset epilogue's order over the stacked slot buffer,
        in ``SpmmPlan.merge_ranks``' form, built once: rank ``k`` lists
        ``(slots, rows)`` with each row's k-th live slot in the stacked
        ``(shard, lane, slot)`` order.  Rows of a rank are distinct, across
        shards too, so a rank is one gather, add and scatter with no
        repeated target, and a row several slots share (split by ``chunk``
        within a shard or by ``device_chunk`` across shards) sums them in
        stacked order.  At one shard this is the shard plan's
        ``merge_ranks``."""
        off = self.slot_offsets
        rows = np.concatenate([p.slot_row.reshape(-1) for p in self.shards])
        slots = np.concatenate([off[d] + np.arange(p.slot_row.size)
                                for d, p in enumerate(self.shards)])
        live = rows >= 0
        rows, slots = rows[live], slots[live]         # stacked order
        rank = np.zeros(rows.size, np.int64)
        seen: Dict[int, int] = {}
        for i, r in enumerate(rows.tolist()):
            rank[i] = seen.get(r, 0)
            seen[r] = rank[i] + 1
        return [(slots[rank == k].astype(np.int64),
                 rows[rank == k].astype(np.int64))
                for k in range(int(rank.max(initial=-1)) + 1)]

    def on_device(self, device: torch.device) -> dict:
        """The executor's tensors on ``device``, copied once per device.
        ``shards[d]``: ``order``, shard d's plan order composed with its
        ``gather`` (A's global slots; pad steps, which ``step_col < 0``
        masks, name slot 0); ``stacked_runs``, its run table with the
        slots moved to ``slot_offsets[d]`` in the stacked buffer; its own
        ``step_col``, ``runs`` and shard-local ``local_order``; ``own``,
        the global slots of its live local slots (int64: what a mesh
        device that does not hold A's payload takes of it).  ``merge`` is
        :attr:`merge_ranks` as tensors."""
        key = str(device)
        cached = self._on_device.get(key)
        if cached is None:
            as_t = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(
                a if dt is None else a.astype(dt))).to(device)
            shards = []
            for d, p in enumerate(self.shards):
                glob = np.where(p.step_col >= 0, self.gather[d][p.order], 0)
                stacked = p.runs.copy()
                stacked[:, 3] += self.slot_offsets[d]
                shards.append({
                    "order": as_t(glob, np.int32),
                    "stacked_runs": as_t(stacked),
                    "step_col": as_t(p.step_col), "runs": as_t(p.runs),
                    "local_order": as_t(p.order),
                    "own": as_t(self.gather[d][self.gather_live[d]],
                                np.int64)})
            cached = {"shards": shards,
                      "merge": [(as_t(s), as_t(r))
                                for s, r in self.merge_ranks]}
            self._on_device[key] = cached
        return cached


def _shard_pattern(a: BlockCSR, items: List[Tuple[int, int, int]],
                   slot_cap: int) -> Tuple[BlockCSR, np.ndarray, np.ndarray]:
    """One device's rows as a metadata-only BlockCSR sub-pattern.

    ``items`` are ``(row, lo, hi)`` global block ranges owned by the
    device, sorted by ``(row, lo)``.  Rows keep their global ids; blocks
    are compacted to local slots in item order.  Returns ``(pattern,
    gather, live)`` with ``gather`` mapping local slot → global slot."""
    gm = a.n_block_rows
    cols = np.asarray(a.block_col).astype(np.int32)
    gather = np.zeros(slot_cap, np.int32)
    live = np.zeros(slot_cap, bool)
    block_col = np.full(slot_cap, -1, np.int32)
    block_row = np.full(slot_cap, max(gm - 1, 0), np.int32)
    counts = np.zeros(gm, np.int64)
    t = 0
    for (row, lo, hi) in items:
        ln = hi - lo
        gather[t:t + ln] = np.arange(lo, hi, dtype=np.int32)
        live[t:t + ln] = True
        block_col[t:t + ln] = cols[lo:hi]
        block_row[t:t + ln] = row
        counts[row] += ln
        t += ln
    row_ptr = np.zeros(gm + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    pattern = BlockCSR(
        blocks=torch.zeros((slot_cap, 1, 1)),               # metadata-only
        block_col=block_col, block_row=block_row, row_ptr=row_ptr,
        shape=a.shape, block_shape=a.block_shape)
    return pattern, gather, live


def _planned_steps(row_counts: Dict[int, int], n_lanes: int,
                   chunk: Optional[int], row_atomic: bool) -> int:
    """The ``steps`` that ``_shard_pattern`` + ``plan_spmm`` would give a
    device owning these per-row block counts, without building the plan:
    the planner's own chunk resolution (over the shard's nnzb), split
    offsets, sort and LPT."""
    nnzb = sum(row_counts.values())
    if nnzb <= 0:
        return 1
    eff = None if row_atomic else (
        chunk if chunk is not None else _default_chunk(nnzb, n_lanes))
    chunks: List[Tuple[int, int, int]] = []
    lo = 0
    for row in sorted(row_counts):
        hi = lo + row_counts[row]
        if row_atomic:
            chunks.append((row, lo, hi))
        else:
            for s in range(lo, hi, eff):
                chunks.append((row, s, min(s + eff, hi)))
        lo = hi
    chunks.sort(key=lambda c: (-(c[2] - c[1]), c[0], c[1]))
    _, loads = _lpt_pack([(c[2] - c[1], c) for c in chunks], n_lanes)
    return max(1, int(loads.max()))


def _repack_devices(device_items: List[List[Tuple[int, int, int]]], *,
                    n_lanes: int, chunk: Optional[int], row_atomic: bool,
                    max_rounds: int = 32,
                    max_evals_per_round: int = 512,
                    ) -> List[List[Tuple[int, int, int]]]:
    """Padding-aware repack: a deterministic first-improvement local
    search over item moves and swaps (against strictly lighter items)
    off the critical shards, minimising ``(max planned steps, pad
    slots)``; bounded by ``max_rounds`` × ``max_evals_per_round``."""
    d_ = len(device_items)
    if d_ <= 1:
        return device_items
    items = [list(dev) for dev in device_items]

    def steps_of(dev: List[Tuple[int, int, int]]) -> int:
        counts: Dict[int, int] = {}
        for (row, lo, hi) in dev:
            counts[row] = counts.get(row, 0) + (hi - lo)
        return _planned_steps(counts, n_lanes, chunk, row_atomic)

    def objective(st: List[int]) -> Tuple[int, int]:
        smax = max(st)
        return (smax, sum(smax - s for s in st))

    steps = [steps_of(dev) for dev in items]
    for _ in range(max_rounds):
        cur = objective(steps)
        smax = max(steps)
        evals = 0
        improved = False
        for src in range(d_):
            if steps[src] != smax or improved:
                continue
            src_items = sorted(items[src],
                               key=lambda c: (-(c[2] - c[1]), c[0], c[1]))
            dsts = sorted((d for d in range(d_) if d != src),
                          key=lambda d: (steps[d], d))
            for it in src_items:
                if improved or evals >= max_evals_per_round:
                    break
                w_it = it[2] - it[1]
                for dst in dsts:
                    if improved or evals >= max_evals_per_round:
                        break
                    # a plain move, then swaps against lighter dst items
                    backs: List[Optional[Tuple[int, int, int]]] = [None]
                    backs += sorted(
                        (j for j in items[dst] if (j[2] - j[1]) < w_it),
                        key=lambda c: (c[2] - c[1], c[0], c[1]))
                    for back in backs:
                        new_src = [x for x in items[src] if x != it]
                        new_dst = items[dst] + [it]
                        if back is not None:
                            new_dst = [x for x in new_dst if x != back]
                            new_src = new_src + [back]
                        st = list(steps)
                        st[src] = steps_of(new_src)
                        st[dst] = steps_of(new_dst)
                        evals += 1
                        if objective(st) < cur:
                            items[src], items[dst] = new_src, new_dst
                            steps = st
                            improved = True
                            break
                        if evals >= max_evals_per_round:
                            break
        if not improved:
            break
    return items


def plan_partitioned_spmm(a: BlockCSR, *, n_shards: int,
                          n_lanes: int = 8,
                          chunk: Optional[int] = None,
                          device_chunk: Optional[int] = None,
                          row_atomic: bool = False,
                          n_col_shards: int = 1,
                          repack: bool = True) -> PartitionedSpmmPlan:
    """Partition ``a``'s block-rows across ``n_shards`` devices and plan
    each shard with the lane scheduler (the reference's planner).

    ``device_chunk``: ``None`` keeps block-rows whole (every row on one
    device); an integer splits heavier rows into pieces that may land on
    different devices (``split_rows``).  ``n_lanes`` / ``chunk`` /
    ``row_atomic`` are the per-shard knobs of :func:`plan_spmm`.
    ``n_col_shards`` only records the column split; ``repack`` runs the
    padding-aware repack after the count-LPT."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} < 1")
    if n_col_shards < 1:
        raise ValueError(f"n_col_shards={n_col_shards} < 1")
    if device_chunk is not None and device_chunk < 1:
        raise ValueError(f"device_chunk={device_chunk} < 1")
    rptr = np.asarray(a.row_ptr).astype(np.int64)
    gm = a.n_block_rows

    # 1. device-level work items: whole rows, or bounded pieces of them
    items: List[Tuple[int, int, int]] = []
    for i in range(gm):
        lo, hi = int(rptr[i]), int(rptr[i + 1])
        if hi <= lo:
            continue
        if device_chunk is None:
            items.append((i, lo, hi))
        else:
            for s in range(lo, hi, device_chunk):
                items.append((i, s, min(s + device_chunk, hi)))

    # 2. LPT across devices, longest item first onto the lightest device
    items.sort(key=lambda c: (-(c[2] - c[1]), c[0], c[1]))
    device_items, _ = _lpt_pack([(c[2] - c[1], c) for c in items], n_shards)
    if repack and n_shards > 1:
        device_items = _repack_devices(device_items, n_lanes=n_lanes,
                                       chunk=chunk, row_atomic=row_atomic)
    for lane in device_items:
        lane.sort(key=lambda c: (c[0], c[1]))

    # 3. shard-local sub-patterns and their compact plans
    slot_cap = max(max((sum(c[2] - c[1] for c in d) for d in device_items),
                       default=0), 1)
    shards: List[SpmmPlan] = []
    gathers, lives = [], []
    for d in range(n_shards):
        pattern, gather, live = _shard_pattern(a, device_items[d], slot_cap)
        shards.append(plan_spmm(pattern, n_lanes=n_lanes, chunk=chunk,
                                row_atomic=row_atomic, fused="compact"))
        gathers.append(gather)
        lives.append(live)

    # 4. pad the shard plans to one geometry and stack them
    steps = max(p.steps for p in shards)
    r_max = max(p.r_max for p in shards)

    def pad_steps(arr: np.ndarray, *, fill=None) -> np.ndarray:
        # fill=None extends each lane's last column (pad steps prolong the
        # lane's final run, the plan's own pad convention)
        l, s0 = arr.shape
        if s0 == steps:
            return arr.astype(np.int32)
        out = np.empty((l, steps), np.int32)
        out[:, :s0] = arr
        out[:, s0:] = arr[:, -1:] if fill is None else fill
        return out

    order = np.stack([pad_steps(p.order, fill=0) for p in shards])
    step_row = np.stack([pad_steps(p.step_row) for p in shards])
    step_col = np.stack([pad_steps(p.step_col, fill=-1) for p in shards])
    flush_slot = np.stack([pad_steps(p.flush_slot) for p in shards])
    slot_row = np.full((n_shards, n_lanes, r_max), -1, np.int32)
    for d, p in enumerate(shards):
        slot_row[d, :, :p.r_max] = p.slot_row

    # 5. ownership bookkeeping
    row_shard = np.full(gm, -1, np.int32)
    owners: Dict[int, set] = {}
    for d, dev in enumerate(device_items):
        for (row, _, _) in dev:
            owners.setdefault(row, set()).add(d)
    for row, ds in owners.items():
        row_shard[row] = min(ds)
    split = tuple(sorted(r for r, ds in owners.items() if len(ds) > 1))

    return PartitionedSpmmPlan(
        shards=tuple(shards),
        gather=np.stack(gathers), gather_live=np.stack(lives),
        order=order, step_row=step_row, step_col=step_col,
        flush_slot=flush_slot, slot_row=slot_row,
        row_shard=row_shard, split_rows=split, r_max=r_max,
        n_block_rows=gm, block_m=a.block_shape[0], block_k=a.block_shape[1],
        stats=bsr_stats(a), n_col_shards=n_col_shards,
        shard_steps=tuple(p.steps for p in shards),
        shard_r_max=tuple(p.r_max for p in shards))


def plan_partitioned_spmm_vjp(a: BlockCSR, *, n_shards: int,
                              n_lanes: int = 8,
                              chunk: Optional[int] = None,
                              device_chunk: Optional[int] = None,
                              row_atomic: bool = False,
                              n_col_shards: int = 1,
                              repack: bool = True,
                              fwd: Optional[PartitionedSpmmPlan] = None):
    """Partitioned forward plan (or the given ``fwd``) and a partitioned
    transpose side: an ``SpmmTrainPlan`` whose ``bwd`` re-partitions
    Aᵀ's block-rows onto the forward's mesh shape (the forward's row split
    says nothing about Aᵀ's rows).  dA follows the forward's ``gather``
    ownership (``ops._partitioned_sddmm_f32``)."""
    if fwd is None:
        fwd = plan_partitioned_spmm(a, n_shards=n_shards, n_lanes=n_lanes,
                                    chunk=chunk, device_chunk=device_chunk,
                                    row_atomic=row_atomic,
                                    n_col_shards=n_col_shards,
                                    repack=repack)
    elif fwd.n_col_shards != n_col_shards and n_col_shards != 1:
        raise ValueError(
            f"n_col_shards={n_col_shards} but the prebuilt fwd plan "
            f"carries {fwd.n_col_shards} column panels — build them "
            f"together, or drop one")
    return transpose_train_plan(
        a, fwd,
        lambda at: plan_partitioned_spmm(
            at, n_shards=fwd.n_shards, n_lanes=n_lanes, chunk=chunk,
            device_chunk=device_chunk, row_atomic=row_atomic,
            n_col_shards=fwd.n_col_shards, repack=repack))
