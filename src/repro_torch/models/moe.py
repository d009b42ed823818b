"""Mixture-of-Experts layer (port of ``repro.models.moe``).

The dispatch is sort-based, as in the reference: top-k expert assignments
are flattened, stably sorted by expert, ranked within their expert
segment by position, capacity-clamped and written into per-expert
buffers; the three expert products run on the MoE grouped GEMM kernel
(:func:`~repro_torch.kernels.moe_gemm.moe_gemm`, one token tile per
expert buffer, ``bt = cap``), where the reference writes them as
``einsum``; the combine sums each token's k weighted slots.  The layer
trains through ``moe_gemm``'s autograd Function: dx on the same kernel in
its transposed-weight mode, each expert's dW on ``moe_dw_kernel``.

Deliberate differences, which keep the result deterministic on CUDA:

* the dispatch writes kept slots with ``index_put_`` (kept (expert, rank)
  pairs are unique); dropped slots go to a sacrificial row, where the
  reference scatter-adds zeros;
* the combine gathers each token's k slots into a ``(T, k, D)`` tensor
  (in their order in the expert sort) and sums it, instead of an
  ``index_add_``, whose duplicate targets are atomic on CUDA;
* the aux loss counts each expert's assignments with ``bincount``
  (integer counts), where the reference scatter-adds ``1/(T·k)``.

The expert-parallel all-to-all path (``moe_layer_ep``) is not ported yet.
With no device mesh the reference takes the sort-based path for
``impl="ep_a2a"`` too, and so does the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int          # true expert count (router logits)
    n_experts_padded: int   # padded for EP divisibility (pads never routed)
    top_k: int
    d_expert: int           # per-expert FFN width
    capacity_factor: float = 1.25
    impl: str = "gspmd"     # "gspmd" | "ep_a2a" (all-to-all EP)


def init_moe(generator: torch.Generator, cfg: MoEConfig, dtype=torch.float32,
             *, stack=()):
    """Router (f32) and stacked expert weights, drawn on the generator's
    device; a leading ``stack`` shape draws a stack of layers at once."""
    e, d, f = cfg.n_experts_padded, cfg.d_model, cfg.d_expert
    return {
        "router": dense_init(generator, (*stack, d, cfg.n_experts), d,
                             torch.float32),
        "experts_gate": dense_init(generator, (*stack, e, d, f), d, dtype),
        "experts_up": dense_init(generator, (*stack, e, d, f), d, dtype),
        "experts_down": dense_init(generator, (*stack, e, f, d), f, dtype),
    }


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor
              / cfg.n_experts_padded)
    return max(8, ((cap + 7) // 8) * 8)


def route(router: torch.Tensor, cfg: MoEConfig, xt: torch.Tensor, cap: int):
    """The reference's routing of tokens ``xt (T, D)``: f32 router, softmax,
    top-k, renormalised gates, a stable sort of the flat assignments by
    expert, each slot's rank in its expert segment and whether it fits in
    ``cap``.  Returns a dict of those arrays (``order`` indexes the flat
    ``(T·k,)`` assignments; the rest are in sorted order unless named
    per token)."""
    t = xt.shape[0]
    k = cfg.top_k
    logits = xt.float() @ router                              # (T, E_true)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)      # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_e = expert_idx.reshape(-1).to(torch.int32)           # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank within expert segment = index - first index of that expert
    first = torch.searchsorted(sorted_e, sorted_e, right=False)
    rank = (torch.arange(t * k, device=xt.device) - first).to(torch.int32)
    return {"probs": probs, "gate_vals": gate_vals, "expert_idx": expert_idx,
            "flat_e": flat_e, "order": order, "sorted_e": sorted_e,
            "rank": rank, "keep": rank < cap}


def _experts(p, buf: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """SwiGLU over the ``(E·cap, D)`` expert buffers, each product on the
    grouped GEMM kernel with one ``cap``-row tile per expert (its
    Function, so that the products also train)."""
    eot = torch.arange(e, dtype=torch.int32, device=buf.device)
    h = F.silu(moe_gemm(buf, eot, p["experts_gate"], bt=cap))
    h = h * moe_gemm(buf, eot, p["experts_up"], bt=cap)
    return moe_gemm(h, eot, p["experts_down"], bt=cap)


def moe_layer(p, cfg: MoEConfig, x: torch.Tensor, *,
              return_aux: bool = False, mesh=None):
    """x: (B, S, D) → (B, S, D) (+ the load-balancing aux loss with
    ``return_aux``).  ``impl="ep_a2a"`` with a ``mesh`` would take the
    expert-parallel path, which is not ported yet; without one it runs
    the sort-based path, as the reference does with no mesh."""
    if cfg.impl == "ep_a2a" and not return_aux and mesh is not None:
        return moe_layer_ep(p, cfg, x, mesh)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    k = cfg.top_k
    e = cfg.n_experts_padded
    cap = _capacity(t, cfg)
    r = route(p["router"], cfg, xt, cap)
    keep, order = r["keep"], r["order"]

    # ---- sort-based dispatch: kept slots into (E·cap) rows, dropped ones
    # into the sacrificial row E·cap ----------------------------------------
    token_of_slot = torch.div(order, k, rounding_mode="floor")
    dest = torch.where(keep, r["sorted_e"].long() * cap + r["rank"],
                       e * cap)
    buf = x.new_zeros((e * cap + 1, d))
    buf.index_put_((dest,), xt[token_of_slot])
    y_e = _experts(p, buf[:e * cap], e, cap)                 # (E·cap, D)

    # ---- combine: each token's k slots, gathered in sorted order and
    # summed (a dropped slot reads the reference's (0, cap - 1) and is
    # weighted by 0) --------------------------------------------------------
    src = torch.where(keep, dest, cap - 1)
    gates_sorted = r["gate_vals"].reshape(-1)[order]
    w = torch.where(keep, gates_sorted, 0.0).to(x.dtype)
    y_slot = y_e[src] * w[:, None]                            # (T·k, D)
    slots = torch.argsort(order).view(t, k).sort(dim=-1).values
    y = y_slot[slots].sum(dim=1).reshape(b, s, d)

    if not return_aux:
        return y
    # Switch-style load-balance loss over true experts
    me = r["probs"].mean(dim=0)                               # (E_true,)
    ce = torch.bincount(r["flat_e"].long(),
                        minlength=cfg.n_experts).float() / (t * k)
    aux = cfg.n_experts * torch.sum(me * ce)
    return y, aux


def moe_layer_ep(p, cfg: MoEConfig, x, mesh):
    """Expert-parallel MoE with explicit all-to-all dispatch and combine
    over a device mesh."""
    raise NotImplementedError("moe_layer_ep (expert parallelism over a "
                              "device mesh) is not ported yet")
