"""Transformer layers: norms (RMS, layer), RoPE, GQA attention (full,
prefill, decode, paged decode; causal global or local-window, the
encoder's non-causal, and cross-attention to an encoder's K/V), the MLPs
(SwiGLU, GeGLU, the plain two-layer GELU) and the block-sparse projection
(port of ``repro.models.layers``).  Full-sequence attention runs on
:func:`chunked_attention`, flash attention with the reference's
hand-written backward; a serving prefill's causal local window runs
forward only, on the block-sparse local attention kernel
(``ops.local_block_attention``); decode reads its cache by a plain f32
softmax, as the reference's.  Everything is differentiable but the
prefill's local window; the block-sparse projection through
``maple_spmm``'s autograd Function.

Parameters are plain dicts of tensors.  Every ``init_*`` takes an explicit
``torch.Generator`` and creates its tensors on the generator's device; a
leading ``stack`` shape draws a whole stack of layers at once (the
reference's scanned layout: one leading layer axis per leaf).  The
reference draws with ``jax.random``, which torch cannot reproduce, so
parity is held on weights carried across (``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.csr import BlockCSR
from repro_torch.kernels import ops
from repro_torch.kernels.ops import maple_spmm
from repro_torch.regions import region


# --------------------------------------------------------------------------
# initializers / norms
# --------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, in_axis_size: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    # scaled in place: a stacked leaf is held once, not twice, at init
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device).mul_(scale).to(dtype)


def _rms_norm_math(x, weight, eps):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)                          # (..., 1) f32
    return x * inv.to(x.dtype) * (1.0 + weight).to(x.dtype), inv


class _RmsNorm(torch.autograd.Function):
    """The reference's hand-written backward: the statistics and dweight
    reduce in f32, the per-element math stays in x's dtype, so dx comes
    back in x's dtype."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, inv = _rms_norm_math(x, weight, eps)
        ctx.save_for_backward(x, weight, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, inv = ctx.saved_tensors
        inv_x = inv.to(x.dtype)
        dy_w = dy * (1.0 + weight).to(x.dtype)
        m = torch.mean((dy_w * x).float(), dim=-1, keepdim=True)
        dx = dy_w * inv_x - x * ((inv ** 3) * m).to(x.dtype)
        dweight = torch.sum((dy * (x * inv_x)).float(),
                            dim=tuple(range(x.dim() - 1)))
        return dx, dweight.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32, scale by ``(1 + weight)`` (the reference's
    zero-initialised weight convention), in the reference's op order;
    under a gradient, with the reference's backward (:class:`_RmsNorm`)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RmsNorm.apply(x, weight, eps)
    return _rms_norm_math(x, weight, eps)[0]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Mean and variance (about the mean) in f32, then ``(x - mu) ·
    rsqrt(var + eps) · weight + bias`` in x's dtype, as the reference."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mu.to(x.dtype)) * inv * weight.to(x.dtype)
            + bias.to(x.dtype))


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(d: int, kind: str, *, stack: Tuple[int, ...] = (),
              device=None):
    """RMS norm: a zero ``scale`` (applied as ``1 + scale``); layer norm:
    ``scale`` ones and ``bias`` zeros."""
    zeros = torch.zeros((*stack, d), dtype=torch.float32, device=device)
    if kind == "rmsnorm":
        return {"scale": zeros}
    return {"scale": torch.ones_like(zeros), "bias": zeros}


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """``(cos, sin)`` of the RoPE angles, each ``(..., S, 1, hd/2)`` f32.
    Every layer rotates by the same angles, so a forward pass computes
    them once and hands them to each layer."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _rotate(x: torch.Tensor, rope) -> torch.Tensor:
    cos, sin = rope
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: (..., S, H, hd); positions: (..., S) int."""
    return _rotate(x, rope_tables(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """GQA attention, global or local-window (``window`` tokens, causal),
    or non-causal (``causal=False``: the encoder's self-attention and the
    decoder's cross-attention), with optional QKV biases."""
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    window: Optional[int] = None      # local attention window (tokens)
    norm: str = "rmsnorm"


def init_attention(generator: torch.Generator, cfg: AttnConfig,
                   dtype=torch.float32, *, stack: Tuple[int, ...] = ()):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = generator.device
    p = {
        "wq": dense_init(generator, (*stack, d, h, hd), d, dtype),
        "wk": dense_init(generator, (*stack, d, kvh, hd), d, dtype),
        "wv": dense_init(generator, (*stack, d, kvh, hd), d, dtype),
        "wo": dense_init(generator, (*stack, h, hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias:                     # zeros, as the reference's
        p["bq"] = torch.zeros((*stack, h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((*stack, kvh, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((*stack, kvh, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, "rmsnorm", stack=stack, device=dev)
        p["k_norm"] = init_norm(hd, "rmsnorm", stack=stack, device=dev)
    return p


def _project(x, w):
    """``x @ w`` over the leading input axis of ``w``: (B, S, d) × (d, ...)
    → (B, S, ...).  One matmul on a flattened weight view."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).view(
        *x.shape[:-1], *w.shape[1:])


def _rope_of(cfg: AttnConfig, positions, rope):
    """The RoPE tables of ``positions``, or the cached ``rope``."""
    if isinstance(positions, tuple):
        raise TypeError("positions must be the tokens' int positions; pass "
                        "cached rope_tables by the rope= keyword")
    if rope is None:
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    return rope


def _project_qkv(p, cfg: AttnConfig, x, rope):
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
    if cfg.qkv_bias:                     # biases come before qk-norm, RoPE
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:                      # qk-norm comes before RoPE
        q = rms_norm(q, p["q_norm"]["scale"])
        k = rms_norm(k, p["k_norm"]["scale"])
    return _rotate(q, rope), _rotate(k, rope), v


def _out_proj(out, wo):
    """(B, S, H, hd) × (H, hd, d) → (B, S, d)."""
    return torch.matmul(out.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def _gqa_attend(q, k, v, valid, cfg: AttnConfig) -> torch.Tensor:
    """Decode's plain softmax in f32 (the reference's), without repeating
    K/V over head groups.

    q: (B, Sq, H, hd); k/v: (B, Sk, KVH, hd); valid: bool mask
    broadcastable to (B, KVH, G, Sq, Sk) (an (Sk,) one for every row, or
    a per-row (B, 1, 1, 1, Sk) one).  Returns (B, Sq, H, hd) in q's
    dtype."""
    b, sq = q.shape[:2]
    kvh = cfg.n_kv_heads
    grp = cfg.n_heads // kvh
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    qg = (q.float() * scale).view(b, sq, kvh, grp, hd).permute(0, 2, 3, 1, 4)
    s = torch.matmul(qg.reshape(b, kvh, grp * sq, hd),
                     k.float().permute(0, 2, 3, 1))       # (B, KV, G·Sq, Sk)
    s = s.view(b, kvh, grp, sq, -1).masked_fill(~valid, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.matmul(w.view(b, kvh, grp * sq, -1),
                       v.float().permute(0, 2, 1, 3))     # (B, KV, G·Sq, hd)
    out = out.view(b, kvh, grp, sq, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, cfg.n_heads, hd).to(q.dtype)


# --------------------------------------------------------------------------
# chunked flash attention (the reference's custom-VJP flash attention)
# --------------------------------------------------------------------------

Q_CHUNK, KV_CHUNK = 512, 1024     # the reference's default tiles


@dataclasses.dataclass(frozen=True)
class _Tile:
    """Keys ``[k0, k1)`` and the query rows ``[r0, r1)`` (whole q tiles)
    that see at least one of them; ``full`` when every one of those rows
    sees every one of those keys (no mask needed)."""
    k0: int
    k1: int
    r0: int
    r1: int
    full: bool


def _tiles(sq: int, sk: int, causal: bool, window: Optional[int],
           q_chunk: int, kv_chunk: int, q_offset: int):
    """The kv tiles of a call in order, at most ``⌈Sk / kv_chunk⌉`` of
    them; the last may be short, so no length has to divide by a chunk.
    A call whose whole (Sq, Sk) score matrix is no larger than one
    (q_chunk, kv_chunk) tile takes it as one tile.  A tile no row sees is
    left out: it would add exactly nothing (a row's running max, sum and
    output stay as they are under an all-masked tile)."""
    if sq * sk <= q_chunk * kv_chunk:
        q_chunk, kv_chunk = max(sq, 1), max(sk, 1)
    tiles = []
    for k0 in range(0, sk, kv_chunk):
        k1 = min(k0 + kv_chunk, sk)
        lo = max(0, k0 - q_offset) if causal else 0
        hi = sq if window is None else min(sq, k1 - 1 + window - q_offset)
        if lo >= hi:
            continue
        r0 = lo // q_chunk * q_chunk
        r1 = min(-(-hi // q_chunk) * q_chunk, sq)
        full = not (causal and q_offset + r0 < k1 - 1) and not (
            window is not None and q_offset + r1 - 1 - k0 >= window)
        tiles.append(_Tile(k0, k1, r0, r1, full))
    return tiles


def _tile_hidden(t: _Tile, causal: bool, window: Optional[int],
                 q_offset: int, device) -> torch.Tensor:
    """The (positions, 1, keys) mask of what tile ``t`` hides, the
    complement of the reference's ``_tile_mask`` (causal ``qpos >= kpos``,
    a window ``qpos - kpos < window``), the same for every head of a
    group."""
    qpos = (q_offset + torch.arange(t.r0, t.r1, device=device))[:, None,
                                                                 None]
    kpos = torch.arange(t.k0, t.k1, device=device)
    hidden = qpos < kpos if causal else None
    if window is not None:
        far = (qpos - kpos) >= window
        hidden = far if hidden is None else hidden | far
    return hidden


def _hide(s: torch.Tensor, hidden, grp: int, value: float) -> None:
    """``s`` (B, KVH, positions·G, keys) set to ``value`` where ``hidden``
    (positions, 1, keys), in place."""
    if hidden is not None:
        b, kvh, r, kc = s.shape
        s.view(b, kvh, r // grp, grp, kc).masked_fill_(hidden, value)


def _rows(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, hd) → (B, KVH, S·G, hd) f32: the rows of kv head j are
    its group's heads, position-major, so a range of positions is one
    slice."""
    b, s, h, hd = x.shape
    return x.float().reshape(b, s, kvh, h // kvh, hd).transpose(1, 2) \
        .reshape(b, kvh, s * (h // kvh), hd)


def _unrows(x: torch.Tensor, s: int, dtype) -> torch.Tensor:
    """:func:`_rows`' inverse, cast to ``dtype``."""
    b, kvh, _, hd = x.shape
    return x.view(b, kvh, s, -1, hd).transpose(1, 2) \
        .reshape(b, s, -1, hd).to(dtype)


def _forward_tile(rs: slice, ks: slice, qs, k32, v32, hidden, grp: int,
                  run=None):
    """One kv tile (keys ``ks``) of the online softmax over the rows
    ``rs``, with the reference's ``-inf`` handling (a hidden score is
    ``-inf``, so its ``p`` is exactly 0).  ``run`` holds every row's
    running (max, sum, output), updated in place; without it (a call's
    one tile over every row) the tile's own are returned, the values the
    update gives from the running start (-inf, 0, 0)."""
    s = torch.matmul(qs[:, :, rs], k32[:, :, ks].transpose(-1, -2))
    _hide(s, hidden, grp, float("-inf"))
    m_new = s.amax(dim=-1)
    if run is not None:
        m_old = run[0][:, :, rs]
        m_new = torch.maximum(m_old, m_new)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = s.sub_(m_safe[..., None]).exp_()
    l_tile, pv = p.sum(dim=-1), torch.matmul(p, v32[:, :, ks])
    if run is None:
        return m_new, l_tile, pv
    m, l, acc = run
    corr = torch.where(torch.isfinite(m_old), torch.exp(m_old - m_safe),
                       0.0)
    l[:, :, rs] = l[:, :, rs] * corr + l_tile
    acc[:, :, rs] = acc[:, :, rs] * corr[..., None] + pv
    m[:, :, rs] = m_new
    return run


def _backward_tile(rs: slice, ks: slice, qs, q32, k32, v32, dout32, lse,
                   delta, hidden, grp: int, scale: float):
    """One kv tile of the flash backward: ``p`` recomputed from the saved
    log-sum-exp, then dV, dP, ``dS = p (dP - delta)``, and the rows' dQ
    share and the tile's dK, each summed over every row of the tile in one
    product (a fixed order: no scatter, no atomics).  Returns (dQ of the
    rows, dK, dV of the tile)."""
    p = torch.matmul(qs[:, :, rs], k32[:, :, ks].transpose(-1, -2))
    p.sub_(lse[:, :, rs, None]).exp_()
    _hide(p, hidden, grp, 0.0)
    do = dout32[:, :, rs]
    dv = torch.matmul(p.transpose(-1, -2), do)
    ds = torch.matmul(do, v32[:, :, ks].transpose(-1, -2))
    ds.sub_(delta[:, :, rs, None]).mul_(p)
    del p
    return (torch.matmul(ds, k32[:, :, ks]) * scale,
            torch.matmul(ds.transpose(-1, -2), q32[:, :, rs]) * scale, dv)


def _check_heads(q, k, v):
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"chunked_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         f"(B, Sq, H, hd) and (B, Sk, KVH, hd) with KVH "
                         f"dividing H")


@region
def _flash_forward_impl(q, k, v, tiles, whole: bool, causal: bool, window,
                        q_offset: int, with_lse: bool):
    """The flash forward over ``tiles``: ``out`` in q's dtype and, with
    ``with_lse``, the f32 log-sum-exp the backward reads (else None).  A
    fused region for the roofline's walk (the reference's named
    ``_flash_forward_impl``)."""
    b, sq, h, hd = q.shape
    kvh, grp = k.shape[2], h // k.shape[2]
    qs = _rows(q, kvh) * (1.0 / math.sqrt(hd))
    k32 = k.float().transpose(1, 2).contiguous()
    v32 = v.float().transpose(1, 2).contiguous()
    run = None if whole else (
        torch.full(qs.shape[:3], float("-inf"), device=q.device),
        torch.zeros(qs.shape[:3], device=q.device),
        torch.zeros_like(qs))
    for t in tiles:
        hidden = None if t.full else _tile_hidden(t, causal, window,
                                                  q_offset, q.device)
        out = _forward_tile(slice(t.r0 * grp, t.r1 * grp),
                            slice(t.k0, t.k1), qs, k32, v32, hidden,
                            grp, run)
    m, l, acc = run if run is not None else out
    l = torch.clamp(l, min=1e-20)
    out = _unrows(acc / l[..., None], sq, q.dtype)
    lse = (torch.where(torch.isfinite(m), m, 0.0) + torch.log(l)
           if with_lse else None)
    return out, lse


@region
def _flash_backward_impl(q, k, v, out, lse, dout, tiles, whole: bool,
                         causal: bool, window, q_offset: int):
    """The flash backward: ``p`` recomputed tile by tile from the saved
    log-sum-exp; returns (dQ, dK, dV) in their operands' dtypes.  A fused
    region for the roofline's walk (the reference's
    ``_flash_backward_impl``)."""
    b, sq, h, hd = q.shape
    kvh, grp = k.shape[2], h // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q32 = _rows(q, kvh)
    qs = q32 * scale
    k32 = k.float().transpose(1, 2).contiguous()
    v32 = v.float().transpose(1, 2).contiguous()
    dout32 = _rows(dout, kvh)
    delta = (dout32 * _rows(out, kvh)).sum(dim=-1)    # rowsum(dO ⊙ O)
    if not whole:
        dq, dk, dv = (torch.zeros_like(t) for t in (q32, k32, v32))
    for t in tiles:
        hidden = None if t.full else _tile_hidden(t, causal, window,
                                                  q_offset, q.device)
        rs, ks = slice(t.r0 * grp, t.r1 * grp), slice(t.k0, t.k1)
        grads = _backward_tile(rs, ks, qs, q32, k32, v32, dout32, lse,
                               delta, hidden, grp, scale)
        if whole:
            dq, dk, dv = grads
        else:
            dq[:, :, rs] += grads[0]
            dk[:, :, ks], dv[:, :, ks] = grads[1:]
    return (_unrows(dq, sq, q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class _ChunkedAttention(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward keeps
    ``out`` and the f32 log-sum-exp, the backward recomputes ``p`` tile
    by tile.  A call of one tile over every row and key takes the tile's
    own results (no running state, no accumulators)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk, q_offset):
        tiles = _tiles(q.shape[1], k.shape[1], causal, window, q_chunk,
                       kv_chunk, q_offset)
        whole = len(tiles) == 1 and (tiles[0].r0, tiles[0].r1, tiles[0].k0,
                                     tiles[0].k1) == (0, q.shape[1], 0,
                                                      k.shape[1])
        grad = any(ctx.needs_input_grad[:3])
        out, lse = _flash_forward_impl(q, k, v, tiles, whole, causal, window,
                                       q_offset, grad)
        if grad:                              # the backward's residuals
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.meta = (tiles, whole, causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_backward_impl(q, k, v, out, lse, dout, *ctx.meta),
                None, None, None, None, None)


def chunked_attention(q, k, v, causal: bool = True,
                      window: Optional[int] = None, q_chunk: int = Q_CHUNK,
                      kv_chunk: int = KV_CHUNK,
                      q_offset: int = 0) -> torch.Tensor:
    """Flash attention with a hand-written backward (the reference's
    ``chunked_attention``).

    q: (B, Sq, H, hd); k/v: (B, Sk, KVH, hd) with KVH dividing H: head
    ``h`` reads kv head ``h // (H / KVH)``, the function of the
    reference's head-repeated K/V without the copy.  Query ``i`` sits at
    position ``q_offset + i``, key ``j`` at ``j``; ``causal`` masks keys
    after the query, ``window`` keys ``window`` or more positions before
    it.  Returns (B, Sq, H, hd) in q's dtype; everything inside is f32.

    Scores exist one kv tile at a time, for every query row that sees the
    tile at once (the reference's ``vmap`` over q chunks), so a call runs
    at most ``⌈Sk / kv_chunk⌉`` loop steps whatever the lengths (the
    reference picks chunks that divide them, one a step for a prime
    length); ``q_chunk`` is the granularity of the rows a tile takes.
    The backward recomputes ``p`` from the saved log-sum-exp, as the
    reference's, and sums every dK / dV / dQ in a fixed order."""
    _check_heads(q, k, v)
    return _ChunkedAttention.apply(q, k, v, causal, window, q_chunk,
                                   kv_chunk, q_offset)


LOCAL_BLOCK = 128    # ops.local_block_attention's q / kv tile (bq = bk)


def _repeat_kv(k, n_heads: int):
    """(B, S, KVH, hd) → (B, S, H, hd): head h reads kv head h // G."""
    kvh = k.shape[2]
    if kvh == n_heads:
        return k
    return k.repeat_interleave(n_heads // kvh, dim=2)


def _local_attend(q, k, v, cfg: AttnConfig) -> torch.Tensor:
    """Causal attention within ``cfg.window`` on the block-sparse local
    attention kernel (B9 on a card, its plain version on the CPU).  The
    kernel takes one (B, S, H, hd) shape with S a multiple of its
    128-tiles: K/V are repeated over the head groups and S is padded at
    the end, which causality keeps out of every real row; the padding is
    sliced off after the call."""
    s = q.shape[1]
    pad = -s % LOCAL_BLOCK
    q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (
        q, _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads)))
    out = ops.local_block_attention(q, k, v, window=cfg.window,
                                    bq=LOCAL_BLOCK, bk=LOCAL_BLOCK)
    return out[:, :s]


def attention(p, cfg: AttnConfig, x, positions, *, rope=None):
    """Full-sequence self-attention (prefill without a cache).
    ``positions`` (B, S) int are the tokens' positions, as in the
    reference; a caller that already holds their :func:`rope_tables` may
    pass them as ``rope`` (every layer of a forward pass rotates by the
    same angles).  Every mask (causal or not, global or a local window)
    goes through :func:`chunked_attention`, the reference's training
    route."""
    q, k, v = _project_qkv(p, cfg, x, _rope_of(cfg, positions, rope))
    return _out_proj(chunked_attention(q, k, v, cfg.causal, cfg.window),
                     p["wo"])


def attention_prefill(p, cfg: AttnConfig, x, positions, *, cache_len: int,
                      rope=None):
    """Full-sequence attention that also returns the K/V cache
    ``(B, cache_len, KVH, hd)``: zero past the prompt when ``cache_len >=
    S``, else the last ``cache_len`` positions in rolling layout (slot
    ``t % cache_len`` holds position ``t``), so that decode on a
    local-window cache continues seamlessly.  ``positions`` and ``rope``
    as in :func:`attention`.  A causal local window runs on the
    block-sparse local attention kernel (:func:`_local_attend`, B9 on a
    card); every other mask on :func:`chunked_attention`."""
    s = x.shape[1]
    q, k, v = _project_qkv(p, cfg, x, _rope_of(cfg, positions, rope))
    if cfg.window is not None and cfg.causal:
        out = _local_attend(q, k, v, cfg)
    else:
        out = chunked_attention(q, k, v, cfg.causal, cfg.window)
    out = _out_proj(out, p["wo"])
    if cache_len >= s:
        k_cache = F.pad(k, (0, 0, 0, 0, 0, cache_len - s))
        v_cache = F.pad(v, (0, 0, 0, 0, 0, cache_len - s))
    else:
        shift = (s - cache_len) % cache_len
        k_cache = torch.roll(k[:, -cache_len:], shifts=shift, dims=1)
        v_cache = torch.roll(v[:, -cache_len:], shifts=shift, dims=1)
    return out, k_cache, v_cache


def attention_decode(p, cfg: AttnConfig, x, cache_k, cache_v, pos, *,
                     rope=None):
    """One-token decode step against a static KV cache.

    x: (B, 1, D); cache_k/v: (B, S_cache, KVH, hd); ``pos`` the absolute
    position of the new token, a Python int or a 0-dim integer tensor on
    x's device (``rope``, optional, its :func:`rope_tables`).  A global
    cache takes the new K/V at slot ``pos``; a rolling local-window cache
    (``S_cache == window``) at ``pos % S_cache``, its slots masked by the
    absolute position each holds and by the window.  The new K/V are
    written into the caches **in place** (the reference returns updated
    copies; updating in place keeps one cache buffer).  The position is
    never read on the host: the write index and the masks are built from
    it on the device, so a captured step replays at the position its
    buffer holds.  Returns (out, cache_k, cache_v)."""
    if not torch.is_tensor(pos):
        pos = torch.full((), pos, dtype=torch.long, device=x.device)
    if rope is None:
        rope = rope_tables(pos.reshape(1, 1).expand(x.shape[0], 1),
                           cfg.head_dim, cfg.rope_theta)
    s_cache = cache_k.shape[1]
    rolling = cfg.window is not None and s_cache == cfg.window
    write_idx = pos % s_cache if rolling else pos
    q, k_new, v_new = _project_qkv(p, cfg, x, rope)
    at = write_idx.reshape(1).long()
    cache_k.index_copy_(1, at, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v_new.to(cache_v.dtype))
    slot = torch.arange(s_cache, device=x.device)
    # the absolute position each slot holds
    abs_pos = pos - torch.remainder(write_idx - slot, s_cache) if rolling \
        else slot
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if cfg.window is not None:
        valid &= abs_pos > pos - cfg.window
    out = _gqa_attend(q, cache_k, cache_v, valid, cfg)
    return _out_proj(out, p["wo"]), cache_k, cache_v


def attention_decode_paged(p, cfg: AttnConfig, x, pool_k, pool_v, table,
                           pos, *, rope=None):
    """One fused decode step against a paged KV pool.

    x: (B, 1, D), one new token per engine slot; pool_k/v: (n_pages, P,
    KVH, hd), the physical pages every slot shares (page 0 is the dead
    page free slots write into); table: (B, max_pages) int, each slot's
    block table (logical page ``t // P`` → physical page); pos: (B,) int
    on the device, each slot's absolute position (the one this token is
    written to), so slots at different depths share one step.  ``rope``,
    optional, holds the :func:`rope_tables` of ``pos[:, None]``.

    The new K/V are written into the pool **in place** at ``(table[b,
    pos // P], pos % P)`` (the reference returns updated copies; free
    slots all write page 0, offset 0, which is only ever read masked).
    Reads gather the slot's pages into a (B, max_pages·P, KVH, hd) view
    in logical order; entries past the slot's position (or, for a local
    window, at or before ``pos - window``) are masked to -inf, so a
    recycled page's stale tokens get softmax weight exactly 0.0.  Nothing
    here reads a device value on the host.  Returns (out, pool_k,
    pool_v)."""
    psize = pool_k.shape[1]
    if rope is None:
        rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    q, k_new, v_new = _project_qkv(p, cfg, x, rope)

    page_idx = torch.div(pos, psize, rounding_mode="floor").long()
    phys = table.gather(1, page_idx[:, None])[:, 0]
    off = pos.long() % psize
    pool_k[phys, off] = k_new[:, 0].to(pool_k.dtype)
    pool_v[phys, off] = v_new[:, 0].to(pool_v.dtype)

    b = x.shape[0]
    s_len = table.shape[1] * psize
    gk = pool_k[table].reshape(b, s_len, cfg.n_kv_heads, cfg.head_dim)
    gv = pool_v[table].reshape(b, s_len, cfg.n_kv_heads, cfg.head_dim)
    idx = torch.arange(s_len, device=x.device)[None, :]    # logical pos
    valid = idx <= pos[:, None]                            # (B, S)
    if cfg.window is not None:
        valid &= idx > pos[:, None] - cfg.window
    out = _gqa_attend(q, gk, gv, valid[:, None, None, None, :], cfg)
    return _out_proj(out, p["wo"]), pool_k, pool_v


def cross_attention(p, cfg: AttnConfig, x, enc_k, enc_v):
    """Decoder cross-attention of x (B, S, D) over precomputed encoder K/V
    (B, S_enc, KVH, hd): the query projected (and biased), no RoPE, no
    mask, on :func:`chunked_attention` (one tile at decode)."""
    q = _project(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    return _out_proj(chunked_attention(q, enc_k, enc_v, causal=False),
                     p["wo"])


def encode_kv(p, cfg: AttnConfig, enc_out):
    """The cross-attention K/V of the encoder output (B, S_enc, D), projected
    once (and biased), no RoPE."""
    k, v = _project(enc_out, p["wk"]), _project(enc_out, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


GATED = {"silu": F.silu, "gelu_glu": gelu}


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str, dtype=torch.float32, *,
             stack: Tuple[int, ...] = (), sparse_down: bool = False,
             sparse_block=(64, 64), sparse_density: float = 0.25,
             mask_generator: Optional[torch.Generator] = None):
    """MLP params: gated (SwiGLU for ``"silu"``, GeGLU for
    ``"gelu_glu"``), else the plain two-layer GELU (``w_in``, ``b_in``,
    ``w_out``, ``b_out``; biases zero).  ``sparse_down=True`` makes a gated
    MLP's down projection a block-sparse :class:`BlockCSR`; every layer of
    the stack shares one block pattern (drawn from ``mask_generator``)."""
    if activation not in GATED:
        if sparse_down:
            raise ValueError("sparse_down supports the gated (silu/gelu_glu) "
                             f"MLP only, got activation={activation!r}")
        dev = generator.device
        return {
            "w_in": dense_init(generator, (*stack, d_model, d_ff), d_model,
                               dtype),
            "b_in": torch.zeros((*stack, d_ff), dtype=dtype, device=dev),
            "w_out": dense_init(generator, (*stack, d_ff, d_model), d_ff,
                                dtype),
            "b_out": torch.zeros((*stack, d_model), dtype=dtype, device=dev),
        }
    p = {
        "w_gate": dense_init(generator, (*stack, d_model, d_ff), d_model,
                             dtype),
        "w_up": dense_init(generator, (*stack, d_model, d_ff), d_model,
                           dtype),
    }
    if sparse_down:
        p["w_down"] = init_sparse_linear(
            generator, d_ff, d_model, block_shape=sparse_block,
            block_density=sparse_density, dtype=dtype,
            mask_generator=mask_generator, stack=stack)
    else:
        p["w_down"] = dense_init(generator, (*stack, d_ff, d_model), d_ff,
                                 dtype)
    return p


def mlp(p, x, activation: str, *, sparse_plan=None):
    """Gated MLP (SwiGLU, or GeGLU with the tanh GELU), or the plain
    two-layer GELU MLP for any other activation.  A :class:`BlockCSR`
    down projection runs the Maple kernel through :func:`sparse_linear`:

    * with ``sparse_plan`` (the shared ``SpmmTrainPlan`` of
      ``lm.sparse_mlp_plan``, the training path) on that plan, forward
      and backward;
    * without it with ``schedule="naive"``: one kernel launch and no host
      planning per call.  That mirrors the reference's serving path,
      where prefill and decode call ``mlp`` with no plan under
      ``jax.jit``, the traced metadata cannot be planned, and
      ``maple_spmm`` drops to the naive walk; a literal port of the
      default ``"balanced"`` schedule would run a host LPT plan walk on
      every layer of every token.
    """
    if activation not in GATED:
        h = gelu(torch.matmul(x, p["w_in"]) + p["b_in"])
        return torch.matmul(h, p["w_out"]) + p["b_out"]
    h = GATED[activation](torch.matmul(x, p["w_gate"]))
    h = h * torch.matmul(x, p["w_up"])
    if isinstance(p["w_down"], BlockCSR):
        if sparse_plan is not None:
            return sparse_linear(p["w_down"], h, plan=sparse_plan)
        return sparse_linear(p["w_down"], h, schedule="naive")
    return torch.matmul(h, p["w_down"])


# --------------------------------------------------------------------------
# block-sparse projections (the Maple kernel as a model layer)
# --------------------------------------------------------------------------

def init_sparse_linear(generator: torch.Generator, d_in: int, d_out: int, *,
                       block_shape=(64, 64), block_density: float = 0.25,
                       dtype=torch.float32,
                       mask_generator: Optional[torch.Generator] = None,
                       stack: Tuple[int, ...] = ()) -> BlockCSR:
    """Block-sparse ``(d_out, d_in)`` projection weight as BlockCSR.

    Blocks are kept with probability ``block_density`` (drawn from
    ``mask_generator``, default ``generator``); a block-row left empty
    gets block ``(i, i mod gk)`` so no output channel goes dead.  Values
    are ``N(0, 1) / sqrt(max(d_in · density, bk))`` on the generator's
    device.  The container is built directly from the mask (never
    densified); with ``stack`` the payload is ``(*stack, nnzb, bm, bk)``
    over one shared pattern.
    """
    bm, bk = block_shape
    if d_out % bm or d_in % bk:
        raise ValueError(f"({d_out},{d_in}) not divisible by {block_shape}")
    gm, gk = d_out // bm, d_in // bk
    mg = generator if mask_generator is None else mask_generator
    mask = (torch.rand((gm, gk), generator=mg, device=mg.device)
            < block_density).cpu().numpy()
    empty = ~mask.any(axis=1)
    mask[np.nonzero(empty)[0], np.nonzero(empty)[0] % gk] = True
    rows, cols = np.nonzero(mask)
    nnzb = rows.size
    fan_in = max(d_in * block_density, float(bk))
    blocks = torch.randn((*stack, nnzb, bm, bk), generator=generator,
                         device=generator.device) / math.sqrt(fan_in)
    row_ptr = np.zeros((gm + 1,), np.int32)
    np.cumsum(np.bincount(rows, minlength=gm), out=row_ptr[1:])
    return BlockCSR(blocks=blocks.to(dtype), block_col=cols.astype(np.int32),
                    block_row=rows.astype(np.int32), row_ptr=row_ptr,
                    shape=(d_out, d_in), block_shape=(bm, bk))


def sparse_linear(w: BlockCSR, x: torch.Tensor, *, plan=None, bn: int = 128,
                  schedule: str = "balanced") -> torch.Tensor:
    """``y = x @ Wᵀ`` for block-sparse ``W`` in one batched kernel launch.

    ``x`` may be ``(d_in,)``, ``(T, d_in)`` or ``(B, S, d_in)``; tokens
    move to the minor axis (``(B, S, d) → (B, d, S)``) so they become the
    PSB columns, and each batch element is one right-hand side.  ``plan``
    may be a forward ``SpmmPlan``, a ``SpmmTrainPlan`` or ``"auto"`` (the
    memoized autotuner, passed to ``maple_spmm``); the call is
    differentiable in ``w.blocks`` and ``x`` either way.  ``bn`` is the
    kernels' N tile, passed to ``maple_spmm``.

    A ``PartitionedSpmmPlan`` (``plan_partitioned_spmm``, or
    ``plan_spmm_vjp(..., n_shards=D)`` for training) runs the layer over
    ``D`` shards of ``W``'s block-rows (output features), on a mesh of
    cards where ``partition_mesh`` finds one, else one after another on
    ``x``'s device; a plan with ``n_col_shards=C`` splits the tokens into
    ``C`` column panels.  ``schedule="partitioned"`` plans it here."""
    d_out = w.shape[0]
    if x.dim() == 3:
        y = maple_spmm(w, x.transpose(1, 2), plan=plan, bn=bn,
                       schedule=schedule)                 # (B, d_out, S)
        return y.transpose(1, 2)
    flat = x.reshape(-1, x.shape[-1])                     # (T, d_in)
    y = maple_spmm(w, flat.t(), plan=plan, bn=bn, schedule=schedule)
    return y.t().reshape(*x.shape[:-1], d_out)
