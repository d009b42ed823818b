"""MoE grouped GEMM on Hopper (CUDA C++, ``csrc/moe_gemm.cu``).

:func:`moe_gemm` (B8) replaces ``moe_gemm_pallas``
(``repro/kernels/moe_gemm.py``): for expert-sorted, tile-padded tokens
``x (T, D)``, ``y[t] = x[t] @ w[expert_of_tile[t // bt]]`` with the
``(E, D, F)`` expert weights, summed in f32 and written once in x's
dtype.  Routed MoE expert compute is a row-wise product on CSR metadata:
the tile's expert id is the ``col_id`` that selects the weight panel, and
an expert with no tile is never read.

The wrapper runs the plain PyTorch version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; each launch adds one
to ``launches``.  The reference needs D and F to be multiples of its
128-wide Pallas tiles; the kernel takes any D and F, and a token tile bt
that is a multiple of 8 (the MoE layer's capacity always is).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, expert_of_tile, w, bt: int) -> None:
    if x.dim() != 2 or w.dim() != 3 or expert_of_tile.dim() != 1:
        raise ValueError(f"x must be (T, D), w (E, D, F) and expert_of_tile "
                         f"(T/bt,); got {tuple(x.shape)}, {tuple(w.shape)} "
                         f"and {tuple(expert_of_tile.shape)}")
    t, d = x.shape
    if w.shape[1] != d:
        raise ValueError(f"D mismatch {d} vs {w.shape[1]}")
    if bt <= 0 or t % bt:
        raise ValueError(f"T={t} not divisible by bt={bt}")
    if expert_of_tile.shape[0] != t // bt:
        raise ValueError(f"expert_of_tile holds {expert_of_tile.shape[0]} "
                         f"tiles, T/bt = {t // bt}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if expert_of_tile.dtype != torch.int32:
        raise TypeError(f"expert_of_tile must be int32, got "
                        f"{expert_of_tile.dtype}")
    for name, a in (("x", x), ("w", w), ("expert_of_tile", expert_of_tile)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def moe_gemm(x: torch.Tensor, expert_of_tile: torch.Tensor,
             w: torch.Tensor, *, bt: int) -> torch.Tensor:
    """``(T, F)`` in x's dtype: token tile ``i`` (rows ``i·bt`` to
    ``(i+1)·bt``) times ``w[expert_of_tile[i]]``, in f32."""
    _check(x, expert_of_tile, w, bt)
    if not x.is_cuda:
        return moe_gemm_plain(x, expert_of_tile, w, bt=bt)
    if bt % 8:
        raise ValueError(f"the CUDA kernel takes a token tile bt that is a "
                         f"multiple of 8, got {bt}")
    t, d = x.shape
    f = w.shape[2]
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    lib = _build.library("moe_gemm")
    err = lib.maple_moe_gemm(x.data_ptr(), expert_of_tile.data_ptr(),
                             w.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], t,
                             d, f, bt,
                             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "moe_gemm")
    moe_gemm.launches += 1
    return y


moe_gemm.launches = 0


def moe_gemm_plain(x, expert_of_tile, w, *, bt: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_gemm`: one f32 batched product
    over the tiles, each against its expert's gathered weights."""
    t, d = x.shape
    tiles = x.float().view(t // bt, bt, d)
    out = torch.bmm(tiles, w.float()[expert_of_tile.long()])
    return out.reshape(t, w.shape[2]).to(x.dtype)
