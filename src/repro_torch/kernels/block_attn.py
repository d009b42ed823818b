"""Block-sparse local flash attention on Hopper (CUDA C++,
``csrc/block_attn.cu``).

:func:`block_attention` (B9) replaces ``block_attention_pallas``
(``repro/kernels/block_attn.py``).  A local (banded) attention mask is a
banded BSR pattern over (q-block × kv-block) tiles: ``kv_map`` lists the
kv-blocks each q-block may touch (-1 pads), and tiles outside the band
are never fetched, the Maple zero-block skip with the PSB replaced by the
flash (m, l, acc) online-softmax state in f32.

The reference takes one example ``(S, H, hd)`` and ``ops`` vmaps it over
the batch; here the batch ``(B, S, H, hd)`` is one launch.  The wrapper
runs the plain PyTorch version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; each launch adds one to
``launches``.  The kernel takes a head dim that is a multiple of 4 up to
256.

:func:`block_attention` is forward only, on both devices: with grad mode
on and q, k or v requiring grad it raises ``NotImplementedError``, as the
reference's kernel does under ``jax.grad`` (local attention's backward is
not ported yet).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.regions import region

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def local_window_kv_map(seq: int, window: int, bq: int, bk: int) -> np.ndarray:
    """BSR metadata for a causal local window: the kv-blocks each q-block
    may touch (a banded pattern), ``(nq, max_nb)`` int32, -1 padded."""
    nq = seq // bq
    rows = []
    for i in range(nq):
        q_lo, q_hi = i * bq, (i + 1) * bq - 1
        k_lo = max(0, (q_lo - window + 1) // bk)
        k_hi = q_hi // bk
        rows.append(list(range(k_lo, k_hi + 1)))
    max_nb = max(len(r) for r in rows)
    out = np.full((nq, max_nb), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _check(q, k, v, kv_map, bq: int, bk: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be one (B, S, H, hd) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    s = q.shape[1]
    if s % bq or s % bk:
        raise ValueError(f"S={s} vs blocks ({bq},{bk})")
    if kv_map.dim() != 2 or kv_map.shape[0] != s // bq:
        raise ValueError(f"kv_map must be (S/bq, max_nb) = ({s // bq}, ·), "
                         f"got {tuple(kv_map.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype} and {v.dtype}")
    if kv_map.dtype != torch.int32:
        raise TypeError(f"kv_map must be int32, got {kv_map.dtype}")
    for name, t in (("k", k), ("v", v), ("kv_map", kv_map)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


@region
def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_map: torch.Tensor, *, bq: int = 128, bk: int = 128,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``(B, S, H, hd)`` in q's dtype: flash attention of each q-block
    over the kv-blocks of its ``kv_map`` row (ids in ``[-1, S/bk)``),
    causal and windowed (``window > 0``) within them.  Forward only:
    raises under a gradient of q, k or v."""
    _check(q, k, v, kv_map, bq, bk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "block_attention (B9) has no backward: local attention's "
            "backward is not ported yet (the reference's kernel has no "
            "gradient either)")
    if q.is_meta:
        return torch.empty_like(q)
    if not q.is_cuda:
        return block_attention_plain(q, k, v, kv_map, bq=bq, bk=bk,
                                     causal=causal, window=window)
    b, s, h, hd = q.shape
    if hd % 4 or hd > 256:
        raise ValueError(f"the CUDA kernel takes a head dim that is a "
                         f"multiple of 4 up to 256, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_map", kv_map)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    lib = _build.library("block_attn")
    nq, max_nb = kv_map.shape
    err = _build.launch(
        lib.maple_block_attention, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_map.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], b, s, h, hd, nq, max_nb, bq, bk,
        int(causal), window, math.sqrt(hd))
    _build.check(lib, err, "block_attention")
    block_attention.launches += 1
    return out


block_attention.launches = 0


def block_attention_plain(q, k, v, kv_map, *, bq: int = 128, bk: int = 128,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_attention`: q-block by
    q-block, the live entries of its ``kv_map`` row in order, with the
    reference's online softmax (``m_safe``, ``corr``, ``max(l, 1e-20)``)
    in f32."""
    b, s, h, hd = q.shape
    scale = math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(q)
    rows = kv_map.tolist()
    dev = q.device
    for i, row in enumerate(rows):
        qb = qf[:, i * bq:(i + 1) * bq]                      # (B, bq, H, hd)
        qpos = i * bq + torch.arange(bq, device=dev)
        m = torch.full((b, h, bq), -math.inf, device=dev)
        l = torch.zeros((b, h, bq), device=dev)
        acc = torch.zeros((b, h, bq, hd), device=dev)
        for kv_id in row:
            if kv_id < 0:
                continue
            kb = kf[:, kv_id * bk:(kv_id + 1) * bk]
            vb = vf[:, kv_id * bk:(kv_id + 1) * bk]
            sc = torch.einsum("bqhd,bkhd->bhqk", qb, kb) / scale
            kpos = kv_id * bk + torch.arange(bk, device=dev)
            mask = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window > 0:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            sc = torch.where(mask, sc, -math.inf)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(sc - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            m = m_new
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                       vb)
        o = acc / torch.clamp(l, min=1e-20)[..., None]
        out[:, i * bq:(i + 1) * bq] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out
