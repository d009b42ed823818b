"""SDDMM kernels on Hopper: the dA halves of the ``maple_spmm`` and
``maple_spgemm`` backwards.

:func:`maple_sddmm_bsr` (CUDA C++, ``csrc/maple_sddmm.cu``) replaces
``maple_sddmm_bsr_pallas`` (``repro/kernels/maple_sddmm.py``): for
``C = A·B`` with A block-sparse, the payload gradient is ``dC·Bᵀ``
sampled at A's block pattern, one f32 ``(bm, bk)`` tile per block slot,
with pad slots (``block_col < 0``) zero.  A dense ``dC·Bᵀ`` is never
formed.  ``dC`` and ``B`` are f32 or bf16 (alike), summed in f32 in a
fixed order: two runs give the same bits.  ``N`` may be ragged.  ``bn``
is the reference's N tile; the Hopper kernel stages N in 128-byte rows
whatever it is (the CUDA source's header says how).

:func:`maple_sddmm_csr` replaces ``maple_sddmm_csr_pallas``: the
element-granular dA of the SpGEMM.  It reads the SpGEMM's device plan, so
it is defined in :mod:`repro_torch.kernels.maple_spgemm` beside B5 and
re-exported here, where the reference keeps it.

:func:`sddmm_shard_meta` is the host's half of the partitioned dA
(``ops._partitioned_sddmm_f32``): each shard's local slots named by block
row and column.

A wrapper runs its plain PyTorch version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; each launch adds one
to its ``launches`` count.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.maple_spgemm import (  # noqa: F401  (re-export)
    maple_sddmm_csr, maple_sddmm_csr_plain)
from repro_torch.regions import region

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# slots a CTA (at most 32); 0 lets the launcher spread the slots evenly
# over every CTA the card holds at once (at most 16 a CTA)
CHUNK = 0


def sddmm_shard_meta(gather: np.ndarray, gather_live: np.ndarray,
                     block_row: np.ndarray, block_col: np.ndarray,
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-shard block metadata of the partitioned dA (the reference's).

    ``gather`` / ``gather_live`` are a ``PartitionedSpmmPlan``'s
    ``(D, slot_cap)`` payload maps, ``block_row`` / ``block_col`` the
    global pattern.  Returns ``(sd_row, sd_col)``, ``(D, slot_cap)`` int32:
    the row and column each shard's local slot names, dead slots at row 0
    and column -1 (the pad B2 computes zeros for)."""
    gat = np.asarray(gather)
    live = np.asarray(gather_live)
    br = np.asarray(block_row)[gat]
    bc = np.asarray(block_col)[gat]
    sd_row = np.where(live, br, 0).astype(np.int32)
    sd_col = np.where(live, bc, -1).astype(np.int32)
    return sd_row, sd_col


def _check_operands(dc, b3, block_row, block_col, bm, bk):
    if dc.dim() != 3 or b3.dim() != 3:
        raise ValueError(f"dC must be (G, M, N) and B (G, K, N); got "
                         f"{tuple(dc.shape)} and {tuple(b3.shape)}")
    if dc.shape[0] != b3.shape[0] or dc.shape[2] != b3.shape[2]:
        raise ValueError(f"dC {tuple(dc.shape)} and B {tuple(b3.shape)} "
                         f"disagree on G or N")
    if dc.dtype not in _DTYPES or b3.dtype != dc.dtype:
        raise TypeError(f"dC and B must both be float32 or bfloat16, got "
                        f"{dc.dtype} and {b3.dtype}")
    if dc.shape[1] % bm or b3.shape[1] % bk:
        raise ValueError(f"({dc.shape[1]},{b3.shape[1]}) not divisible by "
                         f"block ({bm},{bk})")
    if block_row.shape != block_col.shape or block_row.dim() != 1:
        raise ValueError("block_row and block_col must be one (n_blocks,) "
                         "shape")
    for name, t in (("dC", dc), ("B", b3), ("block_row", block_row),
                    ("block_col", block_col)):
        if t.device != dc.device:
            raise ValueError(f"{name} is on {t.device}, dC on {dc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("block_row", block_row), ("block_col", block_col)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")


@region
def maple_sddmm_bsr(dc: torch.Tensor, b3: torch.Tensor,
                    block_row: torch.Tensor, block_col: torch.Tensor, *,
                    bm: int, bk: int, bn: int = 128) -> torch.Tensor:
    """``(n_blocks, bm, bk)`` f32: slot ``s`` holds ``Σ_g dC[g, row·bm :
    (row+1)·bm] @ B[g, col·bk : (col+1)·bk]ᵀ`` with ``row, col =
    block_row[s], block_col[s]``; slots with ``col < 0`` hold 0."""
    _check_operands(dc, b3, block_row, block_col, bm, bk)
    if dc.is_meta:
        return dc.new_empty((block_col.shape[0], bm, bk),
                            dtype=torch.float32)
    if not dc.is_cuda:
        return maple_sddmm_bsr_plain(dc, b3, block_row, block_col, bm=bm,
                                     bk=bk)
    g, m, n = dc.shape
    n_blocks = block_col.shape[0]
    out = torch.empty((n_blocks, bm, bk), dtype=torch.float32,
                      device=dc.device)
    if n_blocks == 0:
        return out
    lib = _build.library("maple_sddmm")
    err = _build.launch(
        lib.maple_sddmm_bsr, dc.device,
        dc.data_ptr(), b3.data_ptr(), block_row.data_ptr(),
        block_col.data_ptr(), out.data_ptr(), _DTYPES[dc.dtype], n_blocks, g,
        m, b3.shape[1], n, bm, bk, CHUNK)
    _build.check(lib, err, "maple_sddmm_bsr")
    maple_sddmm_bsr.launches += 1
    return out


maple_sddmm_bsr.launches = 0


def maple_sddmm_bsr_plain(dc, b3, block_row, block_col, *, bm: int,
                          bk: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`maple_sddmm_bsr`: gather each live
    slot's dC row tile and B column panel, contract over (G, N)."""
    g, m, n = dc.shape
    k = b3.shape[1]
    out = torch.zeros((block_col.shape[0], bm, bk), dtype=torch.float32,
                      device=dc.device)
    live = torch.nonzero(block_col >= 0)[:, 0]
    if live.numel():
        rows = block_row.long()[live]
        cols = block_col.long()[live]
        dct = dc.float().reshape(g, m // bm, bm, n)[:, rows]
        bt = b3.float().reshape(g, k // bk, bk, n)[:, cols]
        out[live] = torch.einsum("gsin,gskn->sik", dct, bt)
    return out
