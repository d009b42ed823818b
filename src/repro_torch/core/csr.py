"""Padded CSR / BSR containers, the transposes and the sorted-CSR
utilities of the SpGEMM's symbolic phase (port of ``repro.core.csr``).

Metadata (``col_id`` / ``block_col`` / ``block_row`` / ``row_ptr``) is
host numpy, exactly as the reference builds it on the host; the payloads
(``CSR.value``, ``BlockCSR.blocks``) are torch tensors on the device.  The
pad contract is the reference's: pad slots carry ``col = -1`` and a zero
payload, and a BSR pad slot's ``block_row`` points at block-row
``max(gm - 1, 0)``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def _payload_device(dense, device):
    """``(numpy array, device)`` for a host conversion: the payload lands
    on ``device``, by default the tensor's device, else CUDA."""
    if isinstance(dense, torch.Tensor):
        if device is None:
            device = dense.device
        dense = dense.detach().cpu().numpy()
    return np.asarray(dense), resolve_device("cuda" if device is None
                                             else device)


@dataclasses.dataclass
class CSR:
    """Padded CSR matrix: ``value`` on the device, the pattern on the host.

    **Pad contract** (the reference's): slots at index >= ``nnz`` carry
    ``col_id = -1`` and ``value = 0``; consumers mask on ``col_id >= 0``.
    Trailing all-zero rows repeat ``row_ptr``'s final value.
    """

    value: torch.Tensor   # (nnz_max,) float, on the device
    col_id: np.ndarray    # (nnz_max,) int32, -1 on padding
    row_ptr: np.ndarray   # (n_rows + 1,) int32
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_max(self) -> int:
        return self.value.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    def row_lengths(self) -> np.ndarray:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    @classmethod
    def from_dense(cls, dense, nnz_max: int | None = None, *,
                   device=None) -> "CSR":
        """Host conversion (numpy or a tensor); the value lands on
        ``device`` (default: the tensor's device, else CUDA)."""
        dense, dev = _payload_device(dense, device)
        n_rows, n_cols = dense.shape
        rows, cols = np.nonzero(dense)
        nnz = rows.size
        if nnz_max is None:
            nnz_max = max(int(nnz), 1)
        if nnz > nnz_max:
            raise ValueError(f"nnz={nnz} exceeds nnz_max={nnz_max}")
        value = np.zeros((nnz_max,), dtype=dense.dtype)
        col_id = np.full((nnz_max,), -1, dtype=np.int32)
        value[:nnz] = dense[rows, cols]
        col_id[:nnz] = cols
        row_ptr = np.zeros((n_rows + 1,), dtype=np.int32)
        np.cumsum(np.bincount(rows, minlength=n_rows), out=row_ptr[1:])
        return cls(value=torch.from_numpy(value).to(dev), col_id=col_id,
                   row_ptr=row_ptr, shape=(n_rows, n_cols))

    def to_dense(self) -> torch.Tensor:
        """Dense ``(n_rows, n_cols)`` on the value's device (differentiable
        in ``value``).  Pads are masked by ``col_id >= 0``."""
        nnz = self.nnz
        dev = self.value.device
        rows = torch.from_numpy(np.repeat(
            np.arange(self.n_rows, dtype=np.int64),
            np.diff(self.row_ptr.astype(np.int64)))).to(dev)
        cols = torch.from_numpy(self.col_id[:nnz].astype(np.int64)).to(dev)
        out = self.value.new_zeros(self.shape)
        return out.index_put((rows, cols), self.value[:nnz], accumulate=True)

    def row_ids(self) -> np.ndarray:
        """(nnz_max,) int32 — the row that owns each value slot (pads
        resolve to ``n_rows``, as in the reference)."""
        slot = np.arange(self.nnz_max, dtype=np.int32)
        return np.searchsorted(self.row_ptr[1:], slot,
                               side="right").astype(np.int32)

    def check_pad_contract(self) -> "CSR":
        """Host validation of the pad contract (the reference's checks,
        in the same order).  Raises ``ValueError``; returns ``self``."""
        rptr = np.asarray(self.row_ptr)
        nnz = int(rptr[-1])
        if not ((np.diff(rptr) >= 0).all() and nnz <= self.nnz_max):
            raise ValueError("row_ptr not monotone within capacity")
        if not (np.asarray(self.col_id)[nnz:] == -1).all():
            raise ValueError("pad col_id must be -1")
        if bool(self.value[nnz:].any()):
            raise ValueError("pad values must be 0")
        return self


@dataclasses.dataclass
class BlockCSR:
    """Padded block-CSR (BSR): the Maple kernels' metadata format.

    ``blocks[i]`` is the ``(bm, bk)`` payload of the i-th non-zero block
    in row-major (by block-row) order, ``block_col[i]`` its block-column
    (-1 on pads), ``block_row[i]`` its block-row.  ``blocks`` may carry a
    leading layer axis ``(L, n_blocks_max, bm, bk)``: a stack of layers
    sharing one pattern (the sparse MLP's layout); :meth:`layer` takes
    one layer's container.
    """

    blocks: torch.Tensor      # ([L,] n_blocks_max, bm, bk)
    block_col: np.ndarray     # (n_blocks_max,) int32, -1 pad
    block_row: np.ndarray     # (n_blocks_max,) int32, pads = max(gm-1, 0)
    row_ptr: np.ndarray       # (n_block_rows + 1,) int32
    shape: Tuple[int, int]        # dense (M, K)
    block_shape: Tuple[int, int]  # (bm, bk)
    # metadata copies on each device the kernels ran on, made once and
    # shared by every layer of a stack (see kernels.ops.maple_spmm)
    device_meta: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)

    @property
    def n_blocks_max(self) -> int:
        return self.block_col.shape[0]

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block_shape[1]

    @property
    def nnzb(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def stacked(self) -> bool:
        return self.blocks.dim() == 4

    def layer(self, i: int) -> "BlockCSR":
        """The i-th layer of a stacked container (shared metadata)."""
        if not self.stacked:
            raise ValueError("layer() needs a stacked (L, nb, bm, bk) payload")
        return dataclasses.replace(self, blocks=self.blocks[i])

    @classmethod
    def from_dense(cls, dense, block_shape: Tuple[int, int],
                   n_blocks_max: int | None = None, *,
                   device=None) -> "BlockCSR":
        """Host conversion.  ``dense`` is numpy or a tensor; the payload
        lands on ``device`` (default: the tensor's device, else CUDA)."""
        dense, dev = _payload_device(dense, device)
        m, k = dense.shape
        bm, bk = block_shape
        if m % bm or k % bk:
            raise ValueError(
                f"dense {dense.shape} not divisible by {block_shape}")
        gm, gk = m // bm, k // bk
        tiles = dense.reshape(gm, bm, gk, bk).transpose(0, 2, 1, 3)
        nz_mask = np.abs(tiles).sum(axis=(2, 3)) != 0  # (gm, gk)
        rows, cols = np.nonzero(nz_mask)
        nnzb = rows.size
        if n_blocks_max is None:
            n_blocks_max = max(int(nnzb), 1)
        if nnzb > n_blocks_max:
            raise ValueError(
                f"nnz blocks {nnzb} > n_blocks_max {n_blocks_max}")
        blocks = np.zeros((n_blocks_max, bm, bk), dtype=dense.dtype)
        block_col = np.full((n_blocks_max,), -1, dtype=np.int32)
        # pad rows point at the last block-row (the reference's convention)
        block_row = np.full((n_blocks_max,), max(gm - 1, 0), dtype=np.int32)
        blocks[:nnzb] = tiles[rows, cols]
        block_col[:nnzb] = cols
        block_row[:nnzb] = rows
        row_ptr = np.zeros((gm + 1,), dtype=np.int32)
        np.cumsum(np.bincount(rows, minlength=gm), out=row_ptr[1:])
        return cls(blocks=torch.from_numpy(blocks).to(dev),
                   block_col=block_col, block_row=block_row,
                   row_ptr=row_ptr, shape=(m, k), block_shape=(bm, bk))

    def to_dense(self) -> torch.Tensor:
        """Dense ``(M, K)`` (or ``(L, M, K)`` when stacked) on the
        payload's device.  Pads are masked by ``block_col >= 0``."""
        bm, bk = self.block_shape
        gm, gk = self.n_block_rows, self.n_block_cols
        live = np.nonzero(self.block_col >= 0)[0]
        lead = self.blocks.shape[:-3]
        tiles = self.blocks.new_zeros((*lead, gm, gk, bm, bk))
        idx = torch.from_numpy(live).to(self.blocks.device)
        tiles[..., self.block_row[live], self.block_col[live], :, :] = \
            self.blocks.index_select(-3, idx)
        return tiles.transpose(-3, -2).reshape(*lead, gm * bm, gk * bk)

    def check_pad_contract(self) -> "BlockCSR":
        """Host validation of the BSR pad contract (the reference's checks,
        in the same order).  Raises ``ValueError``; returns ``self``."""
        rptr = self.row_ptr
        nnzb = int(rptr[-1])
        if not ((np.diff(rptr) >= 0).all() and nnzb <= self.n_blocks_max):
            raise ValueError("row_ptr not monotone within capacity")
        bcol, brow = self.block_col, self.block_row
        gm = self.n_block_rows
        if nnzb:
            if not ((bcol[:nnzb] >= 0)
                    & (bcol[:nnzb] < self.n_block_cols)).all():
                raise ValueError("live block_col out of range")
            owner = np.repeat(np.arange(gm, dtype=np.int32),
                              np.diff(rptr.astype(np.int64)))
            if not (brow[:nnzb] == owner).all():
                raise ValueError("live block_row disagrees with row_ptr")
        if not (bcol[nnzb:] == -1).all():
            raise ValueError("pad block_col must be -1")
        if not (brow[nnzb:] == max(gm - 1, 0)).all():
            raise ValueError(f"pad block_row must be {max(gm - 1, 0)} "
                             f"(last block row)")
        if bool(self.blocks[..., nnzb:, :, :].any()):
            raise ValueError("pad blocks must be 0")
        return self


def transpose_perm(rows: np.ndarray, cols: np.ndarray):
    """Permutation taking row-major ``(row, col)`` walk order to the
    transpose's: a stable sort by ``(col, row)``.  Returns ``(perm,
    t_rows, t_cols)`` over live entries; ``perm[j]`` is the source slot
    of the j-th live entry of Aᵀ."""
    perm = np.lexsort((rows, cols))
    return perm, cols[perm], rows[perm]


def bsr_transpose_meta(a: BlockCSR, *, pad_to: int | None = None):
    """Host transpose of a BlockCSR *pattern*: ``(perm, block_row,
    block_col, row_ptr, nnzb)`` of Aᵀ, where ``perm`` maps the j-th live
    block of Aᵀ to its source slot in ``a.blocks``.  With ``pad_to`` the
    row / col arrays are padded to that capacity under the container's
    pad contract (col -1, row = the last block-row of Aᵀ)."""
    rptr = np.asarray(a.row_ptr).astype(np.int64)
    nnzb = int(rptr[-1])
    cols = np.asarray(a.block_col)[:nnzb].astype(np.int64)
    rows = np.repeat(np.arange(a.n_block_rows, dtype=np.int64),
                     np.diff(rptr))
    perm, t_rows, t_cols = transpose_perm(rows, cols)
    t_rptr = np.zeros(a.n_block_cols + 1, np.int32)
    np.cumsum(np.bincount(t_rows, minlength=a.n_block_cols), out=t_rptr[1:])
    t_rows = t_rows.astype(np.int32)
    t_cols = t_cols.astype(np.int32)
    if pad_to is not None:
        if pad_to < nnzb:
            raise ValueError(f"n_blocks_max={pad_to} < nnz blocks={nnzb}")
        pad = lambda arr, fill: np.concatenate(
            [arr, np.full(pad_to - nnzb, fill, np.int32)])
        t_rows = pad(t_rows, max(a.n_block_cols - 1, 0))
        t_cols = pad(t_cols, -1)
    return perm.astype(np.int32), t_rows, t_cols, t_rptr, nnzb


def transpose_payload(blocks: torch.Tensor, perm: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """Aᵀ's payload: the ``(nb, bm, bk)`` blocks gathered by ``perm`` (an
    int64 index tensor on their device, Aᵀ live slot -> A slot) and each
    swapped to ``(bk, bm)``, in a zero-filled ``(cap, bk, bm)`` buffer."""
    out = blocks.new_zeros((cap, blocks.shape[2], blocks.shape[1]))
    if perm.numel():
        out[:perm.numel()] = blocks.index_select(0, perm).transpose(1, 2)
    return out


def bsr_transpose(a: BlockCSR, *, n_blocks_max: int | None = None
                  ) -> BlockCSR:
    """Aᵀ as BlockCSR: the transposed pattern (:func:`bsr_transpose_meta`)
    and each ``(bm, bk)`` payload gathered and swapped to ``(bk, bm)``;
    pad slots are zero."""
    if a.stacked:
        raise ValueError("a holds a stack of layers; pass one (a.layer(i))")
    cap = a.n_blocks_max if n_blocks_max is None else int(n_blocks_max)
    perm, block_row, block_col, row_ptr, nnzb = bsr_transpose_meta(
        a, pad_to=cap)
    bm, bk = a.block_shape
    idx = torch.from_numpy(perm[:nnzb].astype(np.int64)).to(a.blocks.device)
    blocks = transpose_payload(a.blocks, idx, cap)
    return BlockCSR(blocks=blocks, block_col=block_col, block_row=block_row,
                    row_ptr=row_ptr, shape=(a.shape[1], a.shape[0]),
                    block_shape=(bk, bm))


def csr_transpose(a: CSR, *, nnz_max: int | None = None) -> CSR:
    """Aᵀ as sorted padded CSR, without densifying: the pattern is walked
    on the host, the values move through one gather on their device
    (differentiable).  Capacity defaults to the input's."""
    rptr = np.asarray(a.row_ptr).astype(np.int64)
    nnz = int(rptr[-1])
    cap = a.nnz_max if nnz_max is None else int(nnz_max)
    if cap < nnz:
        raise ValueError(f"nnz_max={cap} < nnz={nnz}")
    n_rows, n_cols = a.shape
    cols = np.asarray(a.col_id)[:nnz].astype(np.int64)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(rptr))
    perm, t_rows, t_cols = transpose_perm(rows, cols)
    t_rptr = np.zeros(n_cols + 1, np.int32)
    np.cumsum(np.bincount(t_rows, minlength=n_cols), out=t_rptr[1:])
    col_id = np.full(cap, -1, np.int32)
    col_id[:nnz] = t_cols
    value = a.value.new_zeros((cap,))
    if nnz:
        idx = torch.from_numpy(perm.astype(np.int64)).to(a.value.device)
        value = torch.cat([a.value.index_select(0, idx),
                           value[nnz:]])
    return CSR(value=value, col_id=col_id, row_ptr=t_rptr,
               shape=(n_cols, n_rows))


# --------------------------------------------------------------------------
# sorted-CSR utilities (host numpy; the symbolic half of the SpGEMM)
# --------------------------------------------------------------------------

def merge_by_column(cols, vals=None):
    """Merge one row's (column, value) partials by column (Eq. (8)):
    pads (``col < 0``) dropped, columns sorted and unique as int32, values
    summed per column when given.  The per-row oracle of the accumulate
    step, not a hot-path routine."""
    cols = np.asarray(cols).astype(np.int64)
    mask = cols >= 0
    uniq, inv = np.unique(cols[mask], return_inverse=True)
    if vals is None:
        return uniq.astype(np.int32), None
    vals = np.asarray(vals)[mask]
    acc = np.zeros(uniq.size, dtype=vals.dtype)
    np.add.at(acc, inv, vals)
    return uniq.astype(np.int32), acc


def spgemm_row_upper_bounds(a: CSR, b: CSR) -> np.ndarray:
    """Per-row bound on ``nnz(C[i,:])`` for ``C = A @ B``: the row's
    partial products Σ nnz(B[k',:]), capped at the width of B."""
    a_rptr = np.asarray(a.row_ptr).astype(np.int64)
    nnz_a = int(a_rptr[-1])
    a_cols = np.asarray(a.col_id)[:nnz_a].astype(np.int64)
    a_len = np.diff(a_rptr)
    b_len = np.diff(np.asarray(b.row_ptr).astype(np.int64))
    row_of = np.repeat(np.arange(a_len.size), a_len)
    ub = np.bincount(row_of, weights=b_len[a_cols],
                     minlength=a_len.size).astype(np.int64)
    return np.minimum(ub, b.shape[1])


def grow_nnz_max(required: int, current: int = 0, *, floor: int = 8) -> int:
    """Geometric capacity policy: ``max(current, floor)`` doubled until it
    holds ``required``, so drifting nnz reuses a few capacities."""
    if required < 0:
        raise ValueError(f"required={required} < 0")
    if floor < 1:
        raise ValueError(f"floor={floor} < 1")
    cap = max(int(current), floor)
    while cap < required:
        cap *= 2
    return cap


def ell_slots(row_ptr, width: int | None = None):
    """Deprecated shim: :func:`repro_torch.core.formats.ell_slots` is the
    canonical home (imported late: ``core.formats`` imports this
    module)."""
    from repro_torch.core.formats import ell_slots as _ell_slots
    return _ell_slots(row_ptr, width)
