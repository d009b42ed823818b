"""Mamba-2 block: the SSD (state-space duality) chunked algorithm in torch
ops (port of ``repro.models.ssm``).

The SSD scan (Dao & Gu, arXiv:2405.21060) computes the selective-SSM output
in chunks: quadratic attention-like math *within* a chunk (matmuls) and a
linear recurrence *across* chunk states, so decode state is O(1) in the
sequence length.

Shapes follow the paper: ``d_inner = 2·d_model``, heads of size ``headdim``,
a single B/C group, state size N.  The decode path carries
``(conv_state, ssm_state)`` and costs O(d_inner·N) per token.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.regions import region


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    conv_width: int = 4
    chunk: int = 256
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim


def init_ssm(generator: torch.Generator, cfg: SSMConfig, dtype=torch.float32,
             *, stack: Tuple[int, ...] = ()):
    """Random Mamba-2 parameters on the generator's device (``stack``: a
    leading layer shape); ``a_log``, ``d_skip``, ``dt_bias`` and the norm
    are the reference's fixed values."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    dev = generator.device
    proj_out = 2 * di + 2 * n + h          # in_proj emits [z, x, B, C, dt]
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(generator, (*stack, d, proj_out), d, dtype),
        "conv": dense_init(generator, (*stack, cfg.conv_width, di + 2 * n),
                           cfg.conv_width, dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)).expand(
            *stack, h).clone(),
        "d_skip": torch.ones((*stack, h), **f32),
        "dt_bias": torch.zeros((*stack, h), **f32),
        "norm": {"scale": torch.zeros((*stack, di), **f32)},
        "out_proj": dense_init(generator, (*stack, di, d), di, dtype),
    }


def _segsum(x):
    """(..., q) → (..., q, q) lower-triangular segment sums:
    out[i, j] = sum_{k in (j, i]} x[k]  (−inf above the diagonal).

    Each entry sums its own segment only (a running sum down the masked
    columns), where the reference subtracts two running sums over the
    chunk.  The function is the same, but the subtraction cancels: at
    mamba2-2.7b's widths a chunk's log-decays sum to several hundred, and
    a difference of two such f32 sums keeps few bits of a short
    segment's sum, the ones whose decays weigh most."""
    q = x.shape[-1]
    lower = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    terms = x[..., None].expand(*x.shape, q).masked_fill(
        ~lower.tril(-1), 0.0)                       # [i, j] = x[i], i > j
    return torch.cumsum(terms, dim=-2).masked_fill(~lower, float("-inf"))


@region
def ssd_scan(x, dt, a_log, b, c, *, chunk: int):
    """The SSD chunked scan (a fused region for the roofline's walk: the
    reference's named ``_ssd_scan_impl``).

    x:  (B, S, H, P) — inputs per head
    dt: (B, S, H)    — softplus'd step sizes
    a_log: (H,)      — log decay rates (A = -exp(a_log))
    b, c: (B, S, N)  — input/output projections (single group)
    Returns (y (B, S, H, P), final state (B, H, P, N)), both f32.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} not divisible by chunk={chunk}")
    nc = s // chunk
    x, dt, b, c = x.float(), dt.float(), b.float(), c.float()
    a = -torch.exp(a_log.float())                          # (H,) negative

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)

    da_h = (dtc * a).permute(0, 1, 3, 2)                   # (B,nc,H,q)
    da_cum = torch.cumsum(da_h, dim=-1)                    # within-chunk
    da_tot = da_cum[..., -1]                               # (B,nc,H)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)     # (B,nc,H,q,P)

    # intra-chunk: (C·Bᵀ)[i, j] · exp(segsum)[h, i, j], then · x·dt
    seg = _segsum(da_h)                                    # (B,nc,H,q,q)
    cb = torch.matmul(cc, bc.transpose(-1, -2))            # (B,nc,q,q)
    weights = cb[:, :, None] * torch.exp(seg)              # (B,nc,H,q,q)
    y_intra = torch.matmul(weights, xdt)                   # (B,nc,H,q,P)

    # chunk boundary states: Σ_j x·dt[j] · decay_to_end[j] · B[j]; the
    # decay from j to the chunk's end, da_tot - da_cum[j], is the
    # segsum's last row (summed without the cancellation)
    decay_to_end = torch.exp(seg[..., -1, :])              # (B,nc,H,q)
    states = torch.matmul((xdt * decay_to_end[..., None]).transpose(-1, -2),
                          bc[:, :, None])                  # (B,nc,H,P,N)

    # inter-chunk linear recurrence over chunk states (the state *before*
    # each chunk is what that chunk reads)
    prev = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    before = []
    for ci in range(nc):
        before.append(prev)
        prev = prev * torch.exp(da_tot[:, ci])[..., None, None] + \
            states[:, ci]
    prev_states = torch.stack(before, dim=1)               # (B,nc,H,P,N)

    y_inter = torch.matmul(cc[:, :, None], prev_states.transpose(-1, -2)) \
        * torch.exp(da_cum)[..., None]                     # (B,nc,H,q,P)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y, prev


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv1d.  x: (B, S, C); w: (W, C).
    If conv_state (B, W-1, C) is given, runs one-step decode mode."""
    width = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
        new_state = xp[:, -(width - 1):] if width > 1 else None
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
        new_state = xp[:, -(width - 1):]
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out, new_state


def _split_proj(zxbcdt, cfg: SSMConfig):
    di, n = cfg.d_inner, cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt


def ssm_block(p, cfg: SSMConfig, x, *, return_state: bool = False):
    """Full-sequence Mamba-2 block.  x: (B, S, D) → (B, S, D)
    (+ ``(conv_state, ssm_state)`` for decode continuation).  A sequence
    longer than ``cfg.chunk`` must be a multiple of it, as in the
    reference; a shorter one is one chunk."""
    bsz, s, _ = x.shape
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim

    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc_raw, dt = _split_proj(zxbcdt, cfg)
    xbc, conv_state = _causal_conv(xbc_raw, p["conv"])
    xbc = F.silu(xbc)
    xs = xbc[..., :di]
    b = xbc[..., di:di + n]
    c = xbc[..., di + n:]

    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xs.reshape(bsz, s, h, pd)
    chunk = s if s < cfg.chunk else cfg.chunk
    y, final_state = ssd_scan(xh, dt, p["a_log"], b, c, chunk=chunk)
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)

    y = y * F.silu(z)
    y = rms_norm(y, p["norm"]["scale"])
    out = torch.matmul(y, p["out_proj"])
    if return_state:
        return out, (conv_state, final_state)
    return out


def ssm_decode_step(p, cfg: SSMConfig, x, conv_state, ssm_state):
    """One-token decode.  x: (B, 1, D); conv_state: (B, W-1, di+2n);
    ssm_state: (B, H, P, N) f32.  Returns (y, conv_state, ssm_state)."""
    bsz = x.shape[0]
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim

    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :di]
    b = xbc[:, 0, di:di + n].float()                       # (B, N)
    c = xbc[:, 0, di + n:].float()

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])       # (B, H)
    a = -torch.exp(p["a_log"])                             # (H,)
    xh = xs[:, 0].reshape(bsz, h, pd).float()

    decay = torch.exp(dt * a)                              # (B, H)
    drive = (dt[:, :, None] * xh)[..., None] * b[:, None, None, :]
    ssm_state = ssm_state * decay[..., None, None] + drive
    y = torch.matmul(ssm_state, c[:, None, :, None])[..., 0]   # (B, H, P)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)

    y = y * F.silu(z)
    y = rms_norm(y, p["norm"]["scale"])
    return torch.matmul(y, p["out_proj"]), conv_state, ssm_state


def init_ssm_state(cfg: SSMConfig, batch: int, dtype=torch.float32, *,
                   stack: Tuple[int, ...] = (), device=None):
    """Zero ``(conv_state, ssm_state)``: (…, B, W-1, di+2n) in ``dtype``
    and (…, B, H, P, N) f32."""
    return (torch.zeros((*stack, batch, cfg.conv_width - 1,
                         cfg.d_inner + 2 * cfg.d_state), dtype=dtype,
                        device=device),
            torch.zeros((*stack, batch, cfg.n_heads, cfg.headdim,
                         cfg.d_state), dtype=torch.float32, device=device))
