"""SDDMM kernels on Hopper: the dA halves of the ``maple_spmm`` and
``maple_spgemm`` backwards.

:func:`maple_sddmm_bsr` (CUDA C++, ``csrc/maple_sddmm.cu``) replaces
``maple_sddmm_bsr_pallas`` (``repro/kernels/maple_sddmm.py``): for
``C = A·B`` with A block-sparse, the payload gradient is ``dC·Bᵀ``
sampled at A's block pattern, one f32 ``(bm, bk)`` tile per block slot,
with pad slots (``block_col < 0``) zero.  A dense ``dC·Bᵀ`` is never
formed.  ``dC`` and ``B`` are f32 or bf16 (alike), summed in f32 in a
fixed order: two runs give the same bits.  ``N`` may be ragged; ``bn``
caps the N columns the kernel stages in shared memory at a time.

:func:`maple_sddmm_csr` replaces ``maple_sddmm_csr_pallas``: the
element-granular dA of the SpGEMM.  It reads the SpGEMM's device plan, so
it is defined in :mod:`repro_torch.kernels.maple_spgemm` beside B5 and
re-exported here, where the reference keeps it.

A wrapper runs its plain PyTorch version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; each launch adds one
to its ``launches`` count.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.maple_spgemm import (  # noqa: F401  (re-export)
    maple_sddmm_csr, maple_sddmm_csr_plain)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_STAGE = 32          # N columns staged per step (the smem tile width)


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


def maple_sddmm_bsr(dc: torch.Tensor, b3: torch.Tensor,
                    block_row: torch.Tensor, block_col: torch.Tensor, *,
                    bm: int, bk: int, bn: int = 128) -> torch.Tensor:
    """``(n_blocks, bm, bk)`` f32: slot ``s`` holds ``Σ_g dC[g, row·bm :
    (row+1)·bm] @ B[g, col·bk : (col+1)·bk]ᵀ`` with ``row, col =
    block_row[s], block_col[s]``; slots with ``col < 0`` hold 0."""
    _check_operands(dc, b3, block_row, block_col, bm, bk)
    if not dc.is_cuda:
        return maple_sddmm_bsr_plain(dc, b3, block_row, block_col, bm=bm,
                                     bk=bk)
    if bn < 16 or bn & (bn - 1):
        raise ValueError(f"bn={bn}: the CUDA kernel takes a power-of-two N "
                         f"tile of at least 16")
    g, m, n = dc.shape
    n_blocks = block_col.shape[0]
    out = torch.empty((n_blocks, bm, bk), dtype=torch.float32,
                      device=dc.device)
    if n_blocks == 0:
        return out
    stage = min(bn, _MAX_STAGE, max(16, 1 << max(n - 1, 0).bit_length()))
    lib = _build.library("maple_sddmm")
    err = lib.maple_sddmm_bsr(
        dc.data_ptr(), b3.data_ptr(), block_row.data_ptr(),
        block_col.data_ptr(), out.data_ptr(), _DTYPES[dc.dtype], n_blocks,
        g, m, b3.shape[1], n, bm, bk, stage,
        torch.cuda.current_stream().cuda_stream)
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
