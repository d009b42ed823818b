"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; port
of ``repro.models.rglru``).

The recurrence  h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)  is linear in
h, so the full-sequence path runs a log-depth inclusive scan over the
sequence (:func:`rg_lru_scan`) and decode keeps an O(d) hidden state.

Block structure (Griffin recurrent block): two input branches
(linear → causal conv → RG-LRU) × (linear → GeLU), merged multiplicatively,
then an output projection.  ``h`` and ``lambda`` stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gelu


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    lru_width: int
    conv_width: int = 4
    c_exponent: float = 8.0


def init_rglru(generator: torch.Generator, cfg: RGLRUConfig,
               dtype=torch.float32, *, stack: Tuple[int, ...] = ()):
    """Random RG-LRU parameters on the generator's device (``stack``: a
    leading layer shape).  Λ is drawn so that a = sigmoid(Λ)^c spreads
    over (0.9, 0.999), as in the reference."""
    d, w = cfg.d_model, cfg.lru_width
    dev = generator.device
    u = 0.9 + 0.099 * torch.rand((*stack, w), generator=generator,
                                 device=dev)
    root = u ** (1.0 / cfg.c_exponent)
    return {
        "lru_input": dense_init(generator, (*stack, d, w), d, dtype),
        "gate_branch": dense_init(generator, (*stack, d, w), d, dtype),
        "conv": dense_init(generator, (*stack, cfg.conv_width, w),
                           cfg.conv_width, dtype),
        "lru_a_gate": dense_init(generator, (*stack, w, w), w, dtype),
        "lru_x_gate": dense_init(generator, (*stack, w, w), w, dtype),
        "lambda": torch.log(root / (1 - root)).float(),
        "out_proj": dense_init(generator, (*stack, w, d), w, dtype),
    }


def _rg_lru_gates(p, cfg: RGLRUConfig, x):
    """x: (..., W) → (log_a, gated_input), both f32."""
    x32 = x.float()
    r = torch.sigmoid(torch.matmul(x32, p["lru_a_gate"].float()))
    i = torch.sigmoid(torch.matmul(x32, p["lru_x_gate"].float()))
    log_a = -cfg.c_exponent * r * F.softplus(p["lambda"])
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i * x32)
    return log_a, gated


def rg_lru_scan(log_a, gated):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 (seq), with
    the reference's combine ``(a1 + a2, b1·exp(a2) + b2)`` over log-decays:
    a Hillis–Steele scan, ⌈log2 S⌉ steps of whole-tensor ops."""
    la, h = log_a, gated
    s = h.shape[1]
    d = 1
    while d < s:
        la, h = (torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1),
                 torch.cat([h[:, :d], h[:, :-d] * torch.exp(la[:, d:])
                            + h[:, d:]], dim=1))
        d *= 2
    return h


def _conv_taps(xp, conv, s: int):
    """The causal depthwise conv over padded ``xp`` (B, S + W - 1, C): the
    ``W`` taps summed in the reference's order."""
    out = xp[:, 0:s] * conv[0]
    for i in range(1, conv.shape[0]):
        out = out + xp[:, i:i + s] * conv[i]
    return out


def rglru_block(p, cfg: RGLRUConfig, x, *, return_state: bool = False):
    """Full-sequence recurrent block.  x: (B, S, D) → (B, S, D)
    (+ ``(conv_state, h_last)`` for decode continuation)."""
    gate = gelu(torch.matmul(x, p["gate_branch"]))
    u_raw = torch.matmul(x, p["lru_input"])
    width = p["conv"].shape[0]
    up = F.pad(u_raw, (0, 0, width - 1, 0))
    u = _conv_taps(up, p["conv"], x.shape[1])

    log_a, gated = _rg_lru_gates(p, cfg, u)
    h = rg_lru_scan(log_a, gated)

    y = h.to(x.dtype) * gate
    out = torch.matmul(y, p["out_proj"])
    if return_state:
        conv_state = up[:, -(width - 1):] if width > 1 else None
        return out, (conv_state, h[:, -1])
    return out


def rglru_decode_step(p, cfg: RGLRUConfig, x, conv_state, h_prev):
    """One-token decode.  x: (B, 1, D); conv_state: (B, W-1, lru_width);
    h_prev: (B, lru_width) f32.  Returns (y, conv_state, h)."""
    gate = gelu(torch.matmul(x, p["gate_branch"]))
    u = torch.matmul(x, p["lru_input"])
    xp = torch.cat([conv_state.to(u.dtype), u], dim=1)
    width = p["conv"].shape[0]
    conv_state = xp[:, -(width - 1):]
    u = _conv_taps(xp, p["conv"], 1)

    log_a, gated = _rg_lru_gates(p, cfg, u[:, 0])
    h = torch.exp(log_a) * h_prev + gated
    y = h[:, None, :].to(x.dtype) * gate
    return torch.matmul(y, p["out_proj"]), conv_state, h


def init_rglru_state(cfg: RGLRUConfig, batch: int, dtype=torch.float32, *,
                     stack: Tuple[int, ...] = (), device=None):
    """Zero ``(conv_state, h)``: (…, B, W-1, lru_width) in ``dtype`` and
    (…, B, lru_width) f32."""
    return (torch.zeros((*stack, batch, cfg.conv_width - 1, cfg.lru_width),
                        dtype=dtype, device=device),
            torch.zeros((*stack, batch, cfg.lru_width), dtype=torch.float32,
                        device=device))
