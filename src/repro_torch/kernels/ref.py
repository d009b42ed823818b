"""Dense PyTorch oracles of the Maple kernels (port of
``repro.kernels.ref``): the block-sparse × dense SpMM, the ELL ×
row-addressable-B element walk, the MoE grouped GEMM and local attention.

Each computes the same contraction as its kernel, densely and in f32, with
no tile skipping; ``chip_smoke.py`` holds the kernels' entry points
against them at full size.
"""

from __future__ import annotations

import math

import torch


def spmm_ref(blocks: torch.Tensor, block_row: torch.Tensor,
             block_col: torch.Tensor, b_dense: torch.Tensor, *,
             m: int) -> torch.Tensor:
    """BSR × dense reference: scatter the blocks to a dense f32 A (pads
    with ``block_col < 0`` dropped), then one matmul, cast to B's type."""
    _, bm, bk = blocks.shape
    k, n = b_dense.shape
    gm, gk = m // bm, k // bk
    valid = block_col >= 0
    r = torch.where(valid, block_row, 0).long()
    c = torch.where(valid, block_col, 0).long()
    payload = torch.where(valid[:, None, None], blocks.float(), 0.0)
    tiles = torch.zeros((gm * gk, bm, bk), dtype=torch.float32,
                        device=blocks.device)
    tiles.index_add_(0, r * gk + c, payload)
    a_dense = tiles.view(gm, gk, bm, bk).permute(0, 2, 1, 3).reshape(m, k)
    return (a_dense @ b_dense.float()).to(b_dense.dtype)


def spmspm_ref(values: torch.Tensor, col_ids: torch.Tensor,
               b_rows: torch.Tensor) -> torch.Tensor:
    """ELL × row-addressable-B reference (Eq. (3)–(8) vectorized): each
    live slot gathers its B row (the BRB fill) and the PSB sums them."""
    valid = col_ids >= 0
    cols = torch.where(valid, col_ids, 0).long()
    vals = torch.where(valid, values.float(), 0.0)
    gathered = b_rows.float()[cols]                     # (M, L, N)
    return torch.einsum("ml,mln->mn", vals, gathered).to(values.dtype)


def moe_gemm_ref(x: torch.Tensor, expert_of_tile: torch.Tensor,
                 w: torch.Tensor, *, bt: int) -> torch.Tensor:
    """Grouped GEMM reference: per-token expert gather, then batched dot."""
    expert_of_token = torch.repeat_interleave(expert_of_tile.long(), bt)
    w_tok = w[expert_of_token].float()                   # (T, D, F)
    out = torch.einsum("td,tdf->tf", x.float(), w_tok)
    return out.to(x.dtype)


def local_attention_ref(q, k, v, *, window: int) -> torch.Tensor:
    """Dense causal local-window attention oracle.  q/k/v: (B, S, H, hd)."""
    b, s, h, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(hd)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = (qp >= kp) & ((qp - kp) < window)
    scores = torch.where(mask[None, None], scores, -math.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)
