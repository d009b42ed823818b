"""Similarity-based row reordering before planning (port of
``repro.kernels.reorder``).

:func:`reorder_rows` chains element rows greedily by the Jaccard
similarity of their block-column signatures and returns a
:class:`RowReorder`: the permutation, its inverse, the permuted (and
occupancy-refined) block pattern, and the payload gather maps that build
the permuted container from the original one.  :func:`apply_reorder`
builds that container (one gather on the payload's device, outside the
kernels' autograd ``Function``, so the block gradients scatter back to
the original slots); :func:`plan_reordered_spmm` plans on the permuted
pattern and attaches the reorder to the plan, and ``ops.maple_spmm``
permutes A's block-rows before the kernel and inverts the permutation on
the output rows after it.

The reference's numerics contract holds: a row-atomic reordered run is
equal to the unpermuted row-atomic run (only exact-zero contributions
interleave), a chunked one agrees to f32 reassociation; positions the
refined pattern drops get zero gradient.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.csr import BlockCSR
from repro_torch.core.formats import as_block_csr
from repro_torch.kernels.schedule import SpmmPlan, plan_spmm


@dataclasses.dataclass(frozen=True)
class RowReorder:
    """A row permutation and what executing under it needs.

    ``perm[p]`` is the original element row at permuted position ``p``;
    ``inv = argsort(perm)``.  ``block_col`` / ``block_row`` / ``row_ptr``
    are the permuted block pattern (container pad contract upheld);
    ``src_block[s, r]`` / ``src_row[s, r]`` name the original slot and
    local row feeding permuted slot ``s``'s local row ``r``, ``src_live``
    is False where that original block is dead.  ``density_before`` /
    ``density_after`` are the intra-block fill (live elements over
    live-block capacity) before and after.
    """

    perm: np.ndarray        # (M,) int32 — permuted position -> original row
    inv: np.ndarray         # (M,) int32 — original row -> permuted position
    block_col: np.ndarray   # (n_blocks_max,) int32, -1 pads
    block_row: np.ndarray   # (n_blocks_max,) int32, pad rows = last
    row_ptr: np.ndarray     # (n_block_rows + 1,) int32
    src_block: np.ndarray   # (n_blocks_max, bm) int32
    src_row: np.ndarray     # (n_blocks_max, bm) int32
    src_live: np.ndarray    # (n_blocks_max, bm) bool
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    density_before: float
    density_after: float

    @property
    def n_blocks_max(self) -> int:
        return self.block_col.shape[0]

    @property
    def n_blocks(self) -> int:
        return int(self.row_ptr[-1])


def _occupancy(a: BlockCSR) -> np.ndarray:
    """``(nnzb, bm)`` bool: which local rows of each live block hold a
    non-zero (read from the payload on its device)."""
    nnzb = int(np.asarray(a.row_ptr)[-1])
    return (a.blocks[:nnzb].detach().abs().sum(dim=2) != 0).cpu().numpy()


def occupancy_digest(a) -> str:
    """SHA-256 of the per-row live-block occupancy bitmap, the payload
    view :func:`reorder_rows` reads; the autotuner adds it to its cache
    key whenever the reorder knob is searched."""
    occ = _occupancy(as_block_csr(a))
    return hashlib.sha256(np.packbits(occ.reshape(-1)).tobytes()).hexdigest()


def reorder_rows(a) -> RowReorder:
    """Greedy similarity chaining over element-row block signatures (the
    reference's algorithm, same ties): start at the most populated row,
    append the unvisited row most similar to the current one, empty rows
    last in index order; keep the identity unless the chain makes fewer
    blocks.  O(M²) host time and memory over element rows."""
    a = as_block_csr(a)
    if a.stacked:
        raise ValueError("a holds a stack of layers; pass one (a.layer(i))")
    m, k = a.shape
    bm, bk = a.block_shape
    gm, gk = a.n_block_rows, a.n_block_cols
    rptr = np.asarray(a.row_ptr).astype(np.int64)
    nnzb = int(rptr[-1])
    bcol = np.asarray(a.block_col)[:nnzb].astype(np.int64)
    brow = np.repeat(np.arange(gm, dtype=np.int64), np.diff(rptr))

    sig = np.zeros((m, gk), bool)
    if nnzb:
        occ = _occupancy(a)                               # (nnzb, bm)
        el = brow[:, None] * bm + np.arange(bm, dtype=np.int64)[None, :]
        sig[el[occ], np.broadcast_to(bcol[:, None], occ.shape)[occ]] = True
    pop = sig.sum(axis=1)

    nonempty = np.nonzero(pop > 0)[0]
    if nonempty.size:
        s = sig[nonempty].astype(np.float64)
        inter = s @ s.T
        p = pop[nonempty].astype(np.float64)
        union = p[:, None] + p[None, :] - inter
        sim = inter / np.maximum(union, 1.0)
        n = nonempty.size
        visited = np.zeros(n, bool)
        cur = int(np.argmax(p))
        chain = [cur]
        visited[cur] = True
        for _ in range(n - 1):
            cur = int(np.argmax(np.where(visited, -1.0, sim[cur])))
            chain.append(cur)
            visited[cur] = True
        perm = nonempty[np.asarray(chain, dtype=np.int64)]
    else:
        perm = np.zeros((0,), np.int64)
    perm = np.concatenate([perm, np.nonzero(pop == 0)[0]]).astype(np.int32)

    def _grp(p):
        return sig[p].reshape(gm, bm, gk).any(axis=1)     # (gm, gk)

    identity = np.arange(m, dtype=np.int32)
    if int(_grp(perm).sum()) >= int(_grp(identity).sum()):
        perm = identity
    inv = np.argsort(perm).astype(np.int32)

    grp = _grp(perm)
    rows_p, cols_p = np.nonzero(grp)                      # canonical order
    nnzb_p = rows_p.size
    cap_p = max(nnzb_p, 1)
    block_col = np.full((cap_p,), -1, np.int32)
    block_col[:nnzb_p] = cols_p
    block_row = np.full((cap_p,), max(gm - 1, 0), np.int32)
    block_row[:nnzb_p] = rows_p
    row_ptr = np.zeros((gm + 1,), np.int32)
    np.cumsum(grp.sum(axis=1), out=row_ptr[1:])
    slot_of = np.full((gm, gk), -1, np.int64)
    if nnzb:
        slot_of[brow, bcol] = np.arange(nnzb, dtype=np.int64)
    src_block = np.zeros((cap_p, bm), np.int32)
    src_row = np.zeros((cap_p, bm), np.int32)
    src_live = np.zeros((cap_p, bm), bool)
    if nnzb_p:
        orig_el = perm.astype(np.int64)[
            rows_p[:, None] * bm + np.arange(bm, dtype=np.int64)[None, :]]
        src = slot_of[orig_el // bm, cols_p[:, None]]     # (nnzb_p, bm)
        src_live[:nnzb_p] = src >= 0
        src_block[:nnzb_p] = np.maximum(src, 0).astype(np.int32)
        src_row[:nnzb_p] = (orig_el % bm).astype(np.int32)

    nnz_el = int(torch.count_nonzero(a.blocks[:nnzb]))
    return RowReorder(
        perm=perm, inv=inv, block_col=block_col, block_row=block_row,
        row_ptr=row_ptr, src_block=src_block, src_row=src_row,
        src_live=src_live, shape=a.shape, block_shape=a.block_shape,
        density_before=nnz_el / max(nnzb * bm * bk, 1),
        density_after=nnz_el / max(nnzb_p * bm * bk, 1))


def apply_reorder(a, rr: RowReorder) -> BlockCSR:
    """The permuted container: ``rr``'s metadata and one gather from the
    original payload on its device (differentiable: the block gradients
    scatter back to the original slots, dropped positions get none)."""
    a = as_block_csr(a)
    if a.shape != rr.shape or a.block_shape != rr.block_shape:
        raise ValueError(
            f"RowReorder was built for {rr.shape} / blocks "
            f"{rr.block_shape}, operand is {a.shape} / blocks "
            f"{a.block_shape}")
    dev = a.blocks.device
    idx = lambda arr: torch.from_numpy(arr.astype(np.int64)).to(dev)
    gathered = a.blocks[idx(rr.src_block), idx(rr.src_row)]  # (cap, bm, bk)
    blocks = torch.where(torch.from_numpy(rr.src_live).to(dev)[..., None],
                         gathered, 0)
    return BlockCSR(blocks=blocks, block_col=rr.block_col,
                    block_row=rr.block_row, row_ptr=rr.row_ptr,
                    shape=rr.shape, block_shape=rr.block_shape)


def pattern_standin(rr: RowReorder) -> BlockCSR:
    """Metadata-only stand-in holding the permuted pattern, for the
    planner (never executed)."""
    return BlockCSR(blocks=torch.zeros((rr.n_blocks_max, 1, 1)),
                    block_col=rr.block_col, block_row=rr.block_row,
                    row_ptr=rr.row_ptr, shape=rr.shape,
                    block_shape=rr.block_shape)


def plan_reordered_spmm(a, rr: Optional[RowReorder] = None, *,
                        n_lanes: int = 8, chunk: Optional[int] = None,
                        row_atomic: bool = False,
                        fused: str = "auto") -> SpmmPlan:
    """Plan on the permuted pattern and attach the :class:`RowReorder` as
    ``plan.reorder``; pass ``rr`` to reuse one similarity pass."""
    if rr is None:
        rr = reorder_rows(a)
    plan = plan_spmm(pattern_standin(rr), n_lanes=n_lanes, chunk=chunk,
                     row_atomic=row_atomic, fused=fused)
    object.__setattr__(plan, "reorder", rr)
    return plan
