"""Element-granular Maple walk with a dense B on Hopper (CUDA C++,
``csrc/maple_spmspm.cu``).

:func:`maple_spmspm_ell` replaces ``maple_spmspm_pallas``
(``repro/kernels/maple_spmspm.py``): ELL-regularized A ``(M, L)`` (col -1
and value 0 on pads) times a dense ``(K, N)`` B; row i of C is the f32 sum,
in slot order, of ``A[i, t] · B[col(i, t), :]``, written once in A's
dtype.  The reference multiplies pads by 0; both versions here skip them.

The wrapper runs the plain PyTorch version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; each launch adds one
to ``launches``.  The kernel rounds as the plain version does (product,
then sum), so the two give the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.regions import region

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@region
def maple_spmspm_ell(values: torch.Tensor, col_ids: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """``(M, N)`` in A's dtype: ``C[i] = Σ_t values[i, t] ·
    b[col_ids[i, t]]`` over live slots, summed in f32 in slot order."""
    if values.dim() != 2 or col_ids.shape != values.shape or b.dim() != 2:
        raise ValueError(f"values and col_ids must be one (M, L) shape and "
                         f"B (K, N); got {tuple(values.shape)}, "
                         f"{tuple(col_ids.shape)} and {tuple(b.shape)}")
    if values.dtype not in _DTYPES or b.dtype != values.dtype:
        raise TypeError(f"values and B must both be float32 or bfloat16, "
                        f"got {values.dtype} and {b.dtype}")
    if col_ids.dtype != torch.int32:
        raise TypeError(f"col_ids must be int32, got {col_ids.dtype}")
    for name, t in (("values", values), ("col_ids", col_ids), ("B", b)):
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, B on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b.is_meta:
        return values.new_empty((values.shape[0], b.shape[1]))
    if not b.is_cuda:
        return maple_spmspm_ell_plain(values, col_ids, b)
    m, slots = values.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=values.dtype, device=b.device)
    if out.numel() == 0:
        return out
    lib = _build.library("maple_spmspm")
    err = _build.launch(
        lib.maple_spmspm, b.device,
        values.data_ptr(), col_ids.data_ptr(), b.data_ptr(), out.data_ptr(),
        _DTYPES[b.dtype], m, slots, n)
    _build.check(lib, err, "maple_spmspm")
    maple_spmspm_ell.launches += 1
    return out


maple_spmspm_ell.launches = 0


def maple_spmspm_ell_plain(values, col_ids, b) -> torch.Tensor:
    """Plain PyTorch version of :func:`maple_spmspm_ell`: one masked
    multiply-add per slot, in slot order."""
    m, slots = values.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=b.device)
    for t in range(slots if b.shape[0] else 0):     # K = 0: no live slot
        col = col_ids[:, t].long()
        live = (col >= 0)[:, None]
        prod = values[:, t, None].float() * b[col.clamp(min=0)].float()
        acc = acc + torch.where(live, prod, 0.0)
    return acc.to(values.dtype)
