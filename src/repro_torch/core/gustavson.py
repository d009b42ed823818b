"""Gustavson's row-wise product (the paper's Eq. (1)-(7)) as torch oracles
(port of ``repro.core.gustavson``).

* :func:`spmm_rowwise` — CSR ``A`` × dense ``B`` → dense ``C``: every
  non-zero ``A[i,k']`` selects row ``B[k',:]`` (the BRB fill) and the
  scaled row is accumulated into output row ``i`` (the PSB of Eq. (8)).
* :func:`spmspm_rowwise` — CSR ``A`` × CSR ``B`` → dense ``C``, through
  ``B`` densified once.
* :func:`spmspm_rowwise_scan` — the same product a chunk of ``row_chunk``
  output rows at a time: only that chunk's PSB is live.
* :func:`dense_oracle` — densify and matmul.

They run on the operands' device and are differentiable in the values.
They are the oracles the SpGEMM (B5) and element-walk (B7) kernels are
held against, so they are deterministic: where the reference accumulates
with a scatter-add (``out.at[rows].add``), which on a GPU is an atomic
whose order can change a sum, each output entry here sums its terms in a
fixed order (:func:`_sum_in_order`) and two runs are bit-equal.  The
reference's scan walks ``nnz(B)`` steps for every chunk; here a chunk's
partial products are expanded at once and accumulated into its PSB.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.csr import CSR


def _sum_in_order(dest: np.ndarray, terms: Callable, n_dest: int,
                  tail: Tuple[int, ...], dtype, device) -> torch.Tensor:
    """``out[d] = ((0 + t_0) + t_1) + …`` over the items whose ``dest`` is
    ``d``, in item order; ``(n_dest, *tail)``.

    ``dest`` (host int64) lists each item's destination, items in the
    order their adds happen; ``terms(items)`` gives the listed items'
    values, ``(len(items), *tail)``.  Step ``t`` adds the ``t``-th item of
    every destination that has one, destinations sorted by item count so
    that the live ones are a prefix: no two adds of a step meet, so no
    atomics and no order left to the device."""
    out = torch.zeros((n_dest, *tail), dtype=dtype, device=device)
    if dest.size == 0:
        return out
    order = np.argsort(dest, kind="stable")
    ds = dest[order]
    starts = np.flatnonzero(np.r_[True, ds[1:] != ds[:-1]])
    counts = np.diff(np.r_[starts, ds.size])
    by_count = np.argsort(-counts, kind="stable")
    live = np.bincount(counts, minlength=int(counts.max()) + 1)[::-1] \
        .cumsum()[::-1]                      # live[t]: destinations with > t
    acc = torch.zeros((by_count.size, *tail), dtype=dtype, device=device)
    for t in range(int(counts.max())):
        groups = by_count[:live[t + 1]]
        items = torch.from_numpy(order[starts[groups] + t]).to(device)
        acc[:groups.size] += terms(items).to(dtype)
    index = torch.from_numpy(ds[starts[by_count]]).to(device)
    return out.index_copy(0, index, acc)


def _row_of_slot(a: CSR) -> np.ndarray:
    """(nnz,) int64: the row of each live slot."""
    return np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     np.diff(a.row_ptr.astype(np.int64)))


def spmm_rowwise(a: CSR, b_dense: torch.Tensor) -> torch.Tensor:
    """C[M,N] = A_csr[M,K] @ B[K,N] via row-wise product.

    For each non-zero slot s of A (row i, column k' = col_id[s]):
    ``C[i, :] += A.value[s] * B[k', :]``, the slots of a row added in slot
    order.  Pads (``col_id < 0``) contribute nothing."""
    if a.shape[1] != b_dense.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ "
                         f"{tuple(b_dense.shape)}")
    dev = b_dense.device
    dtype = torch.promote_types(b_dense.dtype, a.value.dtype)
    nnz = a.nnz
    live = np.flatnonzero(a.col_id[:nnz] >= 0)
    slot = torch.from_numpy(live).to(dev)
    col = torch.from_numpy(a.col_id[live].astype(np.int64)).to(dev)
    value = a.value.to(dev)

    def terms(i):
        return b_dense[col[i]] * value[slot[i], None]

    # the live slots are listed in slot order: each row sums in slot order
    return _sum_in_order(_row_of_slot(a)[live], terms, a.shape[0],
                         (b_dense.shape[1],), dtype, dev)


def spmspm_rowwise(a: CSR, b: CSR) -> torch.Tensor:
    """C[M,N] = A_csr @ B_csr → dense, both operands in CSR: the rows of B
    densified once, then :func:`spmm_rowwise` (each A slot accumulates the
    entire row k' of B, as the Maple BRB + PSB do)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    return spmm_rowwise(a, b.to_dense())


def spmspm_rowwise_scan(a: CSR, b: CSR, row_chunk: int = 64) -> torch.Tensor:
    """Memory-lean SpMSpM: chunks of ``row_chunk`` A rows, one PSB of
    ``(row_chunk, n_cols)`` live at a time.  A chunk's partial products
    ``A[i,k'] · B[k',j']`` are expanded in A-metadata walk order (slot,
    then B offset) and each PSB entry sums its partials in that order."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    n_rows = a.shape[0]
    if n_rows % row_chunk:
        raise ValueError(f"{n_rows=} not divisible by {row_chunk=}")
    n_out = b.shape[1]
    dev = a.value.device
    dtype = a.value.dtype
    a_rptr = a.row_ptr.astype(np.int64)
    b_rptr = b.row_ptr.astype(np.int64)
    b_len = np.diff(b_rptr)
    a_cols = a.col_id[:a.nnz].astype(np.int64)
    b_cols = b.col_id.astype(np.int64)
    rows = _row_of_slot(a)

    chunks = []
    for r0 in range(0, n_rows, row_chunk):
        s0, s1 = a_rptr[r0], a_rptr[r0 + row_chunk]
        cols = a_cols[s0:s1]
        per = np.where(cols >= 0, b_len[np.maximum(cols, 0)], 0)
        a_slot = np.repeat(np.arange(s0, s1, dtype=np.int64), per)
        first = np.cumsum(per) - per
        b_slot = (np.repeat(b_rptr[np.maximum(cols, 0)], per)
                  + np.arange(a_slot.size, dtype=np.int64)
                  - np.repeat(first, per))
        dest = np.repeat(rows[s0:s1] - r0, per) * n_out + b_cols[b_slot]
        a_idx = torch.from_numpy(a_slot).to(dev)
        b_idx = torch.from_numpy(b_slot).to(dev)
        psb = _sum_in_order(
            dest, lambda i: a.value[a_idx[i]] * b.value[b_idx[i]],
            row_chunk * n_out, (), dtype, dev)
        chunks.append(psb.view(row_chunk, n_out))
    if not chunks:
        return torch.zeros((0, n_out), dtype=dtype, device=dev)
    return torch.cat(chunks)


def dense_oracle(a: CSR, b) -> torch.Tensor:
    """Ground truth: densify and matmul."""
    bd = b.to_dense() if isinstance(b, CSR) else b
    return a.to_dense() @ bd
