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
:func:`moe_route` is the host's side of a launch: the consumer, the token
piece of a thread block, and whether the operands come by TMA.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.maple_spmm import ffma_tile

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PIECES = (8, 16, 32, 64, 96, 128)   # token pieces a thread block can take
F_TILE = 64                         # output columns of a thread block
_RING = 48 * 1024                   # bytes of a block's ring
_MAX_STAGES = 8


def moe_route(dtype: torch.dtype, t: int, d: int, f: int, bt: int, *,
              aligned: bool = True) -> dict:
    """How a B8 launch runs on the card (``plan_moe`` in
    ``csrc/moe_gemm.cu``).  A thread block owns ``piece`` tokens of one
    token tile and :data:`F_TILE` columns of F: the smallest of
    :data:`PIECES` that covers ``bt``, or 128 tokens at a time where
    ``bt`` is wider (``pieces`` blocks a tile, the last one's rows past
    the tile unwritten).  bf16 runs on ``"wgmma"`` (tokens as the
    instruction's N), f32 on ``"ffma"`` with :func:`ffma_tile`'s register
    tile.  Both operands come by ``"tma"`` where D·size and F·size are
    multiples of 16 bytes and the pointers 16-byte aligned, else the
    producer warp copies them (``"producer"``).  A stage holds ``kc``
    rows of D (64; 32 for f32 pieces of 32 tokens or more, so that 3
    blocks share an SM) of x's and w's panels,
    ``(piece + 64) · kc`` elements; ``stages`` of them fill a 48 KB ring
    (2 to 8)."""
    if bt <= 0 or bt % 8 or t % bt:
        raise ValueError(f"bt={bt} must be a positive multiple of 8 that "
                         f"divides T={t}")
    isz = 2 if dtype == torch.bfloat16 else 4
    piece = next((p for p in PIECES if p >= bt), PIECES[-1])
    tma = d > 0 and (d * isz) % 16 == 0 and (f * isz) % 16 == 0 and aligned
    kc = 64 if dtype == torch.bfloat16 or piece < 32 else 32
    stage = (piece + F_TILE) * kc * isz
    return {"consumer": "wgmma" if dtype == torch.bfloat16 else "ffma",
            "register_tile": (None if dtype == torch.bfloat16
                              else ffma_tile(piece, F_TILE)),
            "piece": piece, "pieces": -(-bt // piece), "kc": kc,
            "copy": "tma" if tma else "producer",
            "stages": min(max(_RING // stage, 2), _MAX_STAGES),
            "f_tiles": -(-f // F_TILE)}


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
                             d, f, w.shape[0], bt,
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
