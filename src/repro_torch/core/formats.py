"""The parts of ``repro.core.formats`` the SpGEMM path needs: the ELL slot
map, CSR → ELL regularization, and the lowering of a ``BlockCSR`` onto the
element-granular ``CSR`` it stores.

Host numpy over the pattern; values move through one gather on their
device.  The reference's ELL and bitmap containers are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csr import CSR, BlockCSR


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
    """Lower an operand onto element-granular padded :class:`CSR`.

    CSR passes through untouched.  A ``BlockCSR`` expands every live block
    into its ``bm × bk`` explicit elements (explicit zeros inside live
    blocks included: the symbolic phase needs the stored pattern), sorted
    by column within each element row; the payload moves through one
    gather on its device.
    """
    if isinstance(a, CSR):
        if nnz_max is not None and nnz_max != a.nnz_max:
            raise ValueError(
                "as_element_csr does not re-pad an existing CSR")
        return a
    if not isinstance(a, BlockCSR):
        raise TypeError(
            f"not a CSR or BlockCSR operand: {type(a).__name__} (the ELL "
            f"and bitmap containers are not ported yet)")
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
