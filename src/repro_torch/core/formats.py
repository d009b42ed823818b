"""Multi-format sparse storage behind one ``SparseFormat`` protocol (port
of ``repro.core.formats``): :class:`EllPack` and :class:`BitmapBlocked`
beside ``BlockCSR``, the lossless converters between them
(:func:`as_block_csr`, :func:`to_ell`, :func:`to_bitmap`), the
format-independent pattern view the fingerprint hashes
(:func:`block_pattern_meta`), the element-granular lowering
(:func:`as_element_csr`) and the ELL utilities of the SpGEMM path.

Metadata is host numpy and payloads are torch tensors on their device, as
in ``BlockCSR``.  Every converter lands live blocks in canonical order
(block-row major, ascending block-column within a row), so the packed
payloads of equivalent containers are element for element the same and
every format runs bit-identically through the same kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.core.csr import CSR, BlockCSR, _payload_device


@runtime_checkable
class SparseFormat(Protocol):
    """What every storage format offers: its dense ``shape``,
    :meth:`to_dense` and a host check of its pad contract
    (:meth:`check_pad_contract`, raising ``ValueError``)."""

    shape: Tuple[int, int]

    def to_dense(self) -> torch.Tensor: ...

    def check_pad_contract(self) -> "SparseFormat": ...


BlockFormat = Union["BlockCSR", "EllPack", "BitmapBlocked"]


def _tiles(dense, block_shape):
    """``(tiles (gm, gk, bm, bk), occupancy (gm, gk))`` of a host array."""
    m, k = dense.shape
    bm, bk = block_shape
    if m % bm or k % bk:
        raise ValueError(f"dense {dense.shape} not divisible by {block_shape}")
    tiles = dense.reshape(m // bm, bm, k // bk, bk).transpose(0, 2, 1, 3)
    return tiles, np.abs(tiles).sum(axis=(2, 3)) != 0


def _index(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(
        device)


# --------------------------------------------------------------------------
# EllPack: fixed-width block rows
# --------------------------------------------------------------------------

@dataclasses.dataclass
class EllPack:
    """Blocked ELLPACK: every block-row padded to a fixed slot ``width``.
    ``blocks[R, t]`` is block-row R's t-th live ``(bm, bk)`` payload and
    ``block_col[R, t]`` its block-column.

    **Pad contract**: per block-row the live slots are a contiguous
    prefix with strictly ascending block-columns in ``[0, n_block_cols)``;
    dead slots carry ``block_col = -1`` and a zero payload.
    """

    blocks: torch.Tensor          # (gm, width, bm, bk)
    block_col: np.ndarray         # (gm, width) int32, -1 on dead slots
    shape: Tuple[int, int]        # dense (M, K)
    block_shape: Tuple[int, int]  # (bm, bk)

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block_shape[1]

    @property
    def width(self) -> int:
        return self.blocks.shape[1]

    @classmethod
    def from_dense(cls, dense, block_shape: Tuple[int, int],
                   width: int | None = None, *, device=None) -> "EllPack":
        """Host conversion; raises if ``width`` cannot hold the longest
        block-row.  The payload lands on ``device`` (default: the tensor's
        device, else CUDA)."""
        dense, dev = _payload_device(dense, device)
        tiles, nz_mask = _tiles(dense, block_shape)
        gm = nz_mask.shape[0]
        lens = nz_mask.sum(axis=1)
        lmax = int(lens.max(initial=0))
        if width is None:
            width = max(lmax, 1)
        elif lmax > width:
            raise ValueError(f"width={width} < longest block-row ({lmax})")
        width = max(int(width), 1)
        blocks = np.zeros((gm, width, *block_shape), dtype=dense.dtype)
        block_col = np.full((gm, width), -1, dtype=np.int32)
        rows, cols = np.nonzero(nz_mask)                  # row-major, sorted
        offs = np.arange(rows.size) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        blocks[rows, offs] = tiles[rows, cols]
        block_col[rows, offs] = cols
        return cls(blocks=torch.from_numpy(blocks).to(dev),
                   block_col=block_col, shape=dense.shape,
                   block_shape=tuple(block_shape))

    def to_dense(self) -> torch.Tensor:
        """Dense ``(M, K)`` on the payload's device (differentiable in
        ``blocks``); dead slots are masked by ``block_col >= 0``."""
        bm, bk = self.block_shape
        gm, gk = self.n_block_rows, self.n_block_cols
        r, t = np.nonzero(self.block_col >= 0)
        dev = self.blocks.device
        tiles = self.blocks.new_zeros((gm, gk, bm, bk))
        tiles = tiles.index_put(
            (_index(r, dev), _index(self.block_col[r, t], dev)),
            self.blocks[_index(r, dev), _index(t, dev)], accumulate=True)
        return tiles.transpose(1, 2).reshape(gm * bm, gk * bk)

    def density(self) -> float:
        """Fraction of non-zero blocks."""
        nnzb = int((self.block_col >= 0).sum())
        return nnzb / (self.n_block_rows * self.n_block_cols)

    def check_pad_contract(self) -> "EllPack":
        """Host validation of the pad contract (the reference's checks, in
        the same order).  Raises ``ValueError``; returns ``self``."""
        bcol = self.block_col
        live = bcol >= 0
        if (bcol[~live] != -1).any():
            raise ValueError("dead block_col must be -1")
        if (live[:, 1:] & ~live[:, :-1]).any():
            raise ValueError("live slots must form a contiguous prefix "
                             "per block-row")
        if (bcol[live] >= self.n_block_cols).any():
            raise ValueError("live block_col out of range")
        both = live[:, 1:] & live[:, :-1]
        if (bcol[:, 1:][both] <= bcol[:, :-1][both]).any():
            raise ValueError("live block_col must be strictly ascending "
                             "per block-row")
        dead = torch.from_numpy(~live).to(self.blocks.device)
        if bool(self.blocks[dead].any()):
            raise ValueError("dead-slot blocks must be 0")
        return self

    def to_block_csr(self, n_blocks_max: int | None = None) -> BlockCSR:
        """Lossless ELL → BlockCSR: the row-major walk of live slots is
        already BlockCSR's packed order; the payload moves through one
        gather on its device (differentiable)."""
        gm = self.n_block_rows
        bm, bk = self.block_shape
        live = self.block_col >= 0
        nnzb = int(live.sum())
        cap = max(nnzb, 1) if n_blocks_max is None else int(n_blocks_max)
        if cap < nnzb:
            raise ValueError(f"n_blocks_max={cap} < nnz blocks={nnzb}")
        r_idx, t_idx = np.nonzero(live)                   # row-major walk
        block_col = np.full((cap,), -1, np.int32)
        block_col[:nnzb] = self.block_col[r_idx, t_idx]
        block_row = np.full((cap,), max(gm - 1, 0), np.int32)
        block_row[:nnzb] = r_idx
        row_ptr = np.zeros((gm + 1,), np.int32)
        np.cumsum(np.bincount(r_idx, minlength=gm), out=row_ptr[1:])
        dev = self.blocks.device
        blocks = torch.cat([
            self.blocks[_index(r_idx, dev), _index(t_idx, dev)],
            self.blocks.new_zeros((cap - nnzb, bm, bk))])
        return BlockCSR(blocks=blocks, block_col=block_col,
                        block_row=block_row, row_ptr=row_ptr,
                        shape=self.shape, block_shape=self.block_shape)


# --------------------------------------------------------------------------
# BitmapBlocked: occupancy bitmap + packed payload
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BitmapBlocked:
    """A ``(gm, gk)`` occupancy bitmap plus the live payloads packed in
    bitmap row-major order, which is BlockCSR's canonical order: lowering
    to BlockCSR reuses the payload as it is when the capacity matches.

    **Pad contract**: ``blocks.shape[0] >= bitmap.sum()`` and every slot
    past the live count is a zero payload.
    """

    blocks: torch.Tensor          # (n_blocks_max, bm, bk), row-major packed
    bitmap: np.ndarray            # (gm, gk) bool
    shape: Tuple[int, int]        # dense (M, K)
    block_shape: Tuple[int, int]  # (bm, bk)

    @property
    def n_blocks_max(self) -> int:
        return self.blocks.shape[0]

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block_shape[1]

    @classmethod
    def from_dense(cls, dense, block_shape: Tuple[int, int],
                   n_blocks_max: int | None = None, *,
                   device=None) -> "BitmapBlocked":
        """Host conversion; the payload lands on ``device`` (default: the
        tensor's device, else CUDA)."""
        dense, dev = _payload_device(dense, device)
        tiles, bitmap = _tiles(dense, block_shape)
        rows, cols = np.nonzero(bitmap)
        nnzb = rows.size
        cap = max(int(nnzb), 1) if n_blocks_max is None else int(n_blocks_max)
        if nnzb > cap:
            raise ValueError(f"nnz blocks {nnzb} > n_blocks_max {cap}")
        blocks = np.zeros((cap, *block_shape), dtype=dense.dtype)
        blocks[:nnzb] = tiles[rows, cols]
        return cls(blocks=torch.from_numpy(blocks).to(dev), bitmap=bitmap,
                   shape=dense.shape, block_shape=tuple(block_shape))

    def to_dense(self) -> torch.Tensor:
        """Dense ``(M, K)`` through the BlockCSR lowering."""
        return self.to_block_csr().to_dense()

    def density(self) -> float:
        """Fraction of non-zero blocks."""
        return int(self.bitmap.sum()) / (self.n_block_rows
                                         * self.n_block_cols)

    def check_pad_contract(self) -> "BitmapBlocked":
        """Host validation of the pad contract.  Raises ``ValueError``."""
        nnzb = int(self.bitmap.sum())
        if nnzb > self.n_blocks_max:
            raise ValueError(
                f"bitmap has {nnzb} live blocks > capacity "
                f"{self.n_blocks_max}")
        if bool(self.blocks[nnzb:].any()):
            raise ValueError("pad blocks must be 0")
        return self

    def to_block_csr(self, n_blocks_max: int | None = None) -> BlockCSR:
        """Metadata-only bitmap → BlockCSR: the payload passes through
        untouched when the capacity is the stored one; another capacity
        re-pads it through one copy."""
        gm = self.n_block_rows
        rows, cols = np.nonzero(self.bitmap)
        nnzb = rows.size
        cap = self.n_blocks_max if n_blocks_max is None else int(n_blocks_max)
        if cap < nnzb:
            raise ValueError(f"n_blocks_max={cap} < nnz blocks={nnzb}")
        block_col = np.full((cap,), -1, np.int32)
        block_col[:nnzb] = cols
        block_row = np.full((cap,), max(gm - 1, 0), np.int32)
        block_row[:nnzb] = rows
        row_ptr = np.zeros((gm + 1,), np.int32)
        np.cumsum(np.bincount(rows, minlength=gm), out=row_ptr[1:])
        if cap == self.n_blocks_max:
            blocks = self.blocks
        else:
            blocks = torch.cat([self.blocks[:nnzb], self.blocks.new_zeros(
                (cap - nnzb, *self.block_shape))])
        return BlockCSR(blocks=blocks, block_col=block_col,
                        block_row=block_row, row_ptr=row_ptr,
                        shape=self.shape, block_shape=self.block_shape)


#: The blocked formats ``plan_spmm`` / ``maple_spmm`` accept directly.
BLOCK_FORMATS = (BlockCSR, EllPack, BitmapBlocked)


# --------------------------------------------------------------------------
# converters (BlockCSR is the canonical meeting point)
# --------------------------------------------------------------------------

def _bcsr_live_meta(a: BlockCSR):
    """Host ``(rows, cols, nnzb)`` of the live blocks; raises on duplicate
    block coordinates within a row."""
    if a.stacked:
        raise ValueError("a holds a stack of layers; pass one (a.layer(i))")
    rptr = np.asarray(a.row_ptr).astype(np.int64)
    nnzb = int(rptr[-1])
    cols = np.asarray(a.block_col)[:nnzb].astype(np.int64)
    rows = np.repeat(np.arange(a.n_block_rows, dtype=np.int64),
                     np.diff(rptr))
    same_row = rows[1:] == rows[:-1]
    if (cols[1:][same_row] == cols[:-1][same_row]).any():
        raise ValueError("duplicate block coordinates in operand")
    return rows, cols, nnzb


def as_block_csr(a: BlockFormat,
                 n_blocks_max: int | None = None) -> BlockCSR:
    """Lower any blocked format onto canonical BlockCSR: BlockCSR passes
    through, ELL and bitmap operands through their ``to_block_csr``."""
    if isinstance(a, BlockCSR):
        if n_blocks_max is not None and n_blocks_max != a.n_blocks_max:
            raise ValueError(
                "as_block_csr does not re-pad an existing BlockCSR")
        return a
    if isinstance(a, (EllPack, BitmapBlocked)):
        return a.to_block_csr(n_blocks_max)
    raise TypeError(f"not a blocked sparse format: {type(a).__name__}")


def to_ell(a: BlockFormat, width: int | None = None) -> EllPack:
    """Any blocked format as :class:`EllPack` (lossless: raises if
    ``width`` cannot hold the longest block-row)."""
    if isinstance(a, EllPack):
        if width is not None and width != a.width:
            raise ValueError("to_ell does not re-pad an existing EllPack")
        return a
    b = as_block_csr(a)
    rows, cols, nnzb = _bcsr_live_meta(b)
    gm = b.n_block_rows
    idx, live = ell_slots(b.row_ptr, width)               # (gm, width)
    w = idx.shape[1]
    block_col = np.full((gm, w), -1, np.int32)
    block_col[live] = cols[idx[live]]
    # canonical order: ascending columns within each row, dead slots last
    order = np.argsort(block_col + np.where(
        block_col < 0, np.int64(2) * b.n_block_cols + 2, 0), axis=1,
        kind="stable")
    block_col = np.take_along_axis(block_col, order, axis=1)
    src = np.take_along_axis(np.where(live, idx, 0), order, axis=1)
    live = np.take_along_axis(live, order, axis=1)
    dev = b.blocks.device
    payload = b.blocks[_index(src, dev)]                  # (gm, w, bm, bk)
    payload = torch.where(torch.from_numpy(live).to(dev)[..., None, None],
                          payload, 0)
    return EllPack(blocks=payload, block_col=block_col, shape=b.shape,
                   block_shape=b.block_shape)


def to_bitmap(a: BlockFormat,
              n_blocks_max: int | None = None) -> BitmapBlocked:
    """Any blocked format as :class:`BitmapBlocked`; the payload is reused
    as it is when it is already packed in canonical order at the target
    capacity, else re-packed through one gather."""
    if isinstance(a, BitmapBlocked):
        if n_blocks_max is not None and n_blocks_max != a.n_blocks_max:
            raise ValueError(
                "to_bitmap does not re-pad an existing BitmapBlocked")
        return a
    b = as_block_csr(a)
    rows, cols, nnzb = _bcsr_live_meta(b)
    bitmap = np.zeros((b.n_block_rows, b.n_block_cols), bool)
    bitmap[rows, cols] = True
    cap = b.n_blocks_max if n_blocks_max is None else int(n_blocks_max)
    if cap < nnzb:
        raise ValueError(f"n_blocks_max={cap} < nnz blocks={nnzb}")
    perm = np.lexsort((cols, rows))
    if cap == b.n_blocks_max and (perm == np.arange(nnzb)).all():
        blocks = b.blocks
    else:
        blocks = torch.cat([b.blocks[_index(perm, b.blocks.device)],
                            b.blocks.new_zeros((cap - nnzb,
                                                *b.block_shape))])
    return BitmapBlocked(blocks=blocks, bitmap=bitmap, shape=b.shape,
                         block_shape=b.block_shape)


def block_pattern_meta(a: BlockFormat):
    """Format-independent pattern view ``(shape, block_shape, row_ptr,
    live_cols)``: ``row_ptr`` int64, ``live_cols`` int32 in canonical
    order, byte for byte the same for every format of one pattern."""
    if isinstance(a, BlockCSR):
        rptr = np.asarray(a.row_ptr).astype(np.int64)
        live_cols = np.asarray(a.block_col)[:int(rptr[-1])].astype(np.int32)
    elif isinstance(a, EllPack):
        live = a.block_col >= 0
        rptr = np.zeros((a.n_block_rows + 1,), np.int64)
        np.cumsum(live.sum(axis=1), out=rptr[1:])
        live_cols = a.block_col[live].astype(np.int32)    # row-major walk
    elif isinstance(a, BitmapBlocked):
        rptr = np.zeros((a.n_block_rows + 1,), np.int64)
        np.cumsum(a.bitmap.sum(axis=1), out=rptr[1:])
        live_cols = np.nonzero(a.bitmap)[1].astype(np.int32)
    else:
        raise TypeError(
            f"not a blocked sparse format: {type(a).__name__}")
    return a.shape, a.block_shape, rptr, live_cols


def from_dense(dense, block_shape: Tuple[int, int] | None = None, *,
               format: str = "bcsr", **kw):
    """One front door from dense to any storage format: ``"bcsr"``
    (default), ``"ell"``, ``"bitmap"`` or element-granular ``"csr"``;
    extra keywords go to the format's own ``from_dense``."""
    blocked = {"bcsr": BlockCSR.from_dense, "ell": EllPack.from_dense,
               "bitmap": BitmapBlocked.from_dense}
    if format in blocked:
        if block_shape is None:
            raise ValueError(f"format={format!r} requires block_shape")
        return blocked[format](dense, block_shape, **kw)
    if format == "csr":
        if block_shape is not None:
            raise ValueError("format='csr' is element-granular; "
                             "drop block_shape")
        return CSR.from_dense(dense, **kw)
    raise ValueError(f"unknown format {format!r}; "
                     f"expected bcsr | ell | bitmap | csr")


# --------------------------------------------------------------------------
# element-granular ELL utilities and the element lowering
# --------------------------------------------------------------------------

def ell_slots(row_ptr, width: int | None = None):
    """Gather map from padded-CSR slots to an ``(n_rows, width)`` ELL grid.

    Returns ``(idx, live)``: ``idx[i, t]`` is the CSR slot of row i's t-th
    entry (0 where dead) and ``live[i, t]`` marks real entries.  Raises if
    ``width`` is narrower than the longest row.
    """
    rptr = np.asarray(row_ptr).astype(np.int64)
    lens = np.diff(rptr)
    lmax = int(lens.max(initial=0))
    if width is None:
        width = max(lmax, 1)
    elif lmax > width:
        raise ValueError(f"width={width} < longest row ({lmax})")
    width = max(int(width), 1)
    offs = np.arange(width, dtype=np.int64)[None, :]
    idx = rptr[:-1, None] + offs
    live = offs < lens[:, None]
    return np.where(live, idx, 0).astype(np.int32), live


def csr_to_ell(a: CSR, max_row_len: int | None = None, *,
               truncate: bool = False):
    """CSR → ELL ``(values, col_ids)``, each ``(M, L)`` on the value's
    device (``col_ids`` int32, -1 and value 0 on pads).

    ``max_row_len`` narrower than the longest row would drop entries, so
    it raises unless the caller opts in with ``truncate=True``.
    """
    rptr = np.asarray(a.row_ptr)
    cols = np.asarray(a.col_id)
    m = a.shape[0]
    lens = np.diff(rptr)
    nnz = int(rptr[-1])
    longest = int(lens.max(initial=0))
    if max_row_len is None:
        lmax = max(longest, 1)
    else:
        lmax = max(max_row_len, 1)
        if longest > lmax and not truncate:
            raise ValueError(
                f"max_row_len={max_row_len} would drop entries of a row "
                f"with {longest} non-zeros; pass truncate=True to opt in")
    idx = np.arange(nnz)
    row = np.repeat(np.arange(m), lens)
    offs = idx - np.repeat(rptr[:-1], lens)
    keep = offs < lmax
    ell_c = np.full((m, lmax), -1, dtype=np.int32)
    ell_c[row[keep], offs[keep]] = cols[:nnz][keep]
    dev = a.value.device
    flat = torch.from_numpy((row[keep] * lmax + offs[keep]).astype(np.int64))
    src = torch.from_numpy(idx[keep].astype(np.int64))
    ell_v = a.value.new_zeros((m * lmax,))
    ell_v = ell_v.index_copy(0, flat.to(dev),
                             a.value.index_select(0, src.to(dev)))
    return ell_v.view(m, lmax), torch.from_numpy(ell_c).to(dev)


def as_element_csr(a, nnz_max: int | None = None) -> CSR:
    """Lower any format onto element-granular padded :class:`CSR`.

    CSR passes through untouched.  A blocked operand expands every live
    block into its ``bm × bk`` explicit elements (explicit zeros inside
    live blocks included: the symbolic phase needs the stored pattern),
    sorted by column within each element row; the payload moves through
    one gather on its device.
    """
    if isinstance(a, CSR):
        if nnz_max is not None and nnz_max != a.nnz_max:
            raise ValueError(
                "as_element_csr does not re-pad an existing CSR")
        return a
    a = as_block_csr(a)
    rows, cols, nnzb = _bcsr_live_meta(a)
    rptr = np.asarray(a.row_ptr).astype(np.int64)
    bm, bk = a.block_shape
    m, k = a.shape
    order = np.lexsort((cols, rows))
    s_rows, s_cols = rows[order], cols[order]
    nnz_e = nnzb * bm * bk
    cap = max(nnz_e, 1) if nnz_max is None else int(nnz_max)
    if cap < nnz_e:
        raise ValueError(f"nnz_max={cap} < nnz={nnz_e}")
    row_ptr_e = np.zeros((m + 1,), np.int64)
    np.cumsum(np.repeat(np.diff(rptr), bm) * bk, out=row_ptr_e[1:])
    col_id = np.full((cap,), -1, np.int32)
    value = a.blocks.new_zeros((cap,))
    if nnzb:
        p = np.arange(nnzb, dtype=np.int64)
        p_local = p - rptr[:-1][s_rows]                   # rank within row
        P = np.broadcast_to(p[:, None, None], (nnzb, bm, bk))
        r_i = np.broadcast_to(np.arange(bm)[None, :, None], (nnzb, bm, bk))
        k_i = np.broadcast_to(np.arange(bk)[None, None, :], (nnzb, bm, bk))
        flat = (row_ptr_e[s_rows[P] * bm + r_i] + p_local[P] * bk
                + k_i).ravel()
        col_id[flat] = (s_cols[P] * bk + k_i).ravel()
        # element slot -> flat index into the (nb, bm, bk) payload
        src = np.zeros((nnz_e,), np.int64)
        src[flat] = ((order[P] * bm + r_i) * bk + k_i).ravel()
        dev = a.blocks.device
        value = torch.cat([a.blocks.reshape(-1).index_select(
            0, torch.from_numpy(src).to(dev)), value[nnz_e:]])
    return CSR(value=value, col_id=col_id,
               row_ptr=row_ptr_e.astype(np.int32), shape=(m, k))
