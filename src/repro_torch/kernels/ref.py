"""Dense PyTorch oracles of the MoE grouped GEMM and of local attention
(port of ``repro.kernels.ref::moe_gemm_ref`` and ``local_attention_ref``).

Each computes the same contraction as its kernel, densely and in f32, with
no tile skipping; ``chip_smoke.py`` holds the kernels' entry points
against them at full size.
"""

from __future__ import annotations

import math

import torch


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
