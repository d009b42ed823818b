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

``impl="ep_a2a"`` takes the expert-parallel path (:func:`moe_layer_ep`)
where the bound mesh (``distributed.sharding.use_mesh``) allows it, as
the reference's ``_ep_applicable`` decides; otherwise, and always with
``return_aux``, the sort-based path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (EXPERT_LEAVES, Mesh,
                                              PeerSlices, active_mesh, moved)
from repro_torch.distributed.sharding import same_device as _same_device
from repro_torch.kernels._build import on as _on
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
              return_aux: bool = False):
    """x: (B, S, D) → (B, S, D) (+ the load-balancing aux loss with
    ``return_aux``).  ``impl="ep_a2a"`` takes the expert-parallel path
    (:func:`moe_layer_ep`) where the bound mesh allows it
    (:func:`_ep_applicable`); otherwise the sort-based path below."""
    if cfg.impl == "ep_a2a" and not return_aux and _ep_applicable(cfg):
        return moe_layer_ep(p, cfg, x)
    if isinstance(p["experts_gate"], PeerSlices):
        raise ValueError(
            "expert weights placed over a mesh's model peers "
            "(device_put_params) run only on the expert-parallel path: "
            "impl='ep_a2a' under that mesh, without return_aux")
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


# --------------------------------------------------------------------------
# expert-parallel path: the reference's shard_map all-to-all, in one process
# --------------------------------------------------------------------------
#
# The reference runs ``inner`` once per mesh coordinate under shard_map:
# tokens are split over the batch axes and replicated over ``model``, each
# ``model`` peer owns ``e_loc`` consecutive experts, and one all_to_all over
# ``model`` each way carries per-destination capacity buffers.  The port
# runs the same program batch shard by batch shard in one process: the
# all_to_all is the transpose ``R_p[s] = S_s[p]`` of the send buffers, the
# peers' routing and grouping are batched on the tokens' device, and each
# peer's expert products run on its weights' device (one device for a
# card's or the CPU's mesh; each peer's own card where the weights were
# placed over a mesh of several cards).


def _ep_applicable(cfg: MoEConfig) -> bool:
    mesh = active_mesh()
    if mesh is None or "model" not in mesh.shape:
        return False
    msize = mesh.shape["model"]
    return (cfg.n_experts_padded % msize == 0
            and cfg.d_model % mesh.shape.get("data", 1) == 0)


def _round8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def ep_sizes(mesh: Mesh, cfg: MoEConfig, b: int, s: int) -> Dict:
    """The reference's static sizes of an EP call on a ``(b, s, D)``
    input: the batch axes (the largest of ``(pod, data)``, ``(data,)``,
    ``(pod,)``, ``()`` whose shard count divides ``b``; the others
    replicate), the shard count ``batch_div``, each shard's ``t_loc``
    tokens, ``cap_send`` slots a (source, destination) pair and
    ``cap_exp`` rows a peer's expert."""
    msize = mesh.shape["model"]
    e_loc = cfg.n_experts_padded // msize
    batch_axes = tuple(ax for ax in ("pod", "data") if ax in mesh.shape)
    candidates = [batch_axes]
    if len(batch_axes) > 1:
        candidates += [batch_axes[1:], batch_axes[:1]]
    candidates.append(())
    for cand in candidates:
        batch_div = math.prod(mesh.shape[ax] for ax in cand)
        if b % batch_div == 0:
            batch_axes = cand
            break
    t_loc = (b // batch_div) * s
    cap_send = _round8(int(t_loc * cfg.top_k * cfg.capacity_factor / msize))
    cap_exp = _round8(int(msize * cap_send * 1.25 / e_loc))
    return {"msize": msize, "e_loc": e_loc, "batch_axes": batch_axes,
            "batch_div": batch_div, "t_loc": t_loc, "cap_send": cap_send,
            "cap_exp": cap_exp}


def _ep_route(router, cfg: MoEConfig, xt, msize: int, e_loc: int,
              cap_send: int) -> Dict[str, torch.Tensor]:
    """One coordinate's routing of its ``(t_loc, D)`` tokens: the f32
    router, softmax, top-k and renormalised gates, the flat assignments
    stably sorted by destination peer, each one's rank among its peer's
    and ``keep = rank < cap_send``.  Returned in the flat ``(t_loc·k,)``
    order of the assignments (token-major): ``keep``, ``gates``, ``eid``
    (the expert on its destination) and ``slot``, its row of the flat
    ``(msize·cap_send)`` send buffer, or the sacrificial row
    ``msize·cap_send`` when dropped."""
    t = xt.shape[0]
    k = cfg.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_e = expert_idx.reshape(-1).to(torch.int32)
    dest = torch.div(flat_e, e_loc, rounding_mode="floor")
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    first = torch.searchsorted(sorted_dest, sorted_dest, right=False)
    rank = torch.arange(t * k, device=xt.device) - first
    # each assignment's send row, put back in flat order (a permutation)
    slot = torch.empty_like(rank)
    slot[order] = torch.where(rank < cap_send,
                              sorted_dest.long() * cap_send + rank,
                              msize * cap_send)
    return {"keep": slot < msize * cap_send, "slot": slot,
            "eid": (flat_e % e_loc).to(torch.int32),
            "gates": gate_vals.reshape(-1)}


def _ep_send(xt, r, msize: int, cap_send: int):
    """The ``(msize, cap_send, D)`` token and ``(msize, cap_send)`` expert
    id send buffers (-1 on empty slots).  Each token's row goes to its k
    slots at once (its gradient is then the sum over them, in a fixed
    order).  Only kept slots are written: each has a cell of its own, and
    a dropped slot goes to the sacrificial row, so it can never erase a
    kept slot's id (the reference's ``.set(-1)`` aims every dropped slot
    at cell ``(0, cap_send - 1)``, which a kept slot holds whenever peer 0
    is full)."""
    n = msize * cap_send
    t, d = xt.shape
    k = r["slot"].shape[0] // t
    x_send = xt.new_zeros((n + 1, d))
    x_send.index_put_((r["slot"],),
                      xt.unsqueeze(1).expand(t, k, d).reshape(t * k, d))
    eid_send = torch.full((n + 1,), -1, dtype=torch.int32, device=xt.device)
    eid_send[r["slot"]] = r["eid"]
    return (x_send[:n].view(msize, cap_send, d),
            eid_send[:n].view(msize, cap_send))


def _ep_group(er, e_loc: int, cap_exp: int):
    """Each peer's second-level grouping of its ``N = msize·cap_send``
    received slots (``er``: ``(peers, N)`` expert ids, -1 empty): a stable
    sort by local expert (empty slots last), each slot's rank in its
    expert and ``keep2 = (se < e_loc) & (rank2 < cap_exp)``.  Returns
    each received slot's row in the peers' stacked ``(peers·e_loc·cap_exp)``
    expert buffers, in received order: the sacrificial row
    ``peers·e_loc·cap_exp`` when dropped or empty."""
    g, n = er.shape
    key = torch.where(er >= 0, er, e_loc)
    order2 = torch.argsort(key, dim=-1, stable=True)
    se = key.gather(-1, order2)
    first2 = torch.searchsorted(se, se, right=False)
    rank2 = torch.arange(n, device=er.device) - first2
    keep2 = (se < e_loc) & (rank2 < cap_exp)
    base = torch.arange(g, device=er.device)[:, None] * (e_loc * cap_exp)
    row = torch.where(keep2, base + se.long() * cap_exp + rank2,
                      g * e_loc * cap_exp)
    # back in received order (order2 permutes each peer's row)
    return torch.empty_like(row).scatter_(-1, order2, row)


class _Take(torch.autograd.Function):
    """``x[idx]`` for indices that are unique apart from ``x``'s last row
    (a zero row that dropped entries read): the backward writes each
    row's gradient back to its one source row, with no accumulation, so
    it is deterministic and needs no sort (the last row's is discarded)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gx = g.new_zeros((ctx.rows, g.shape[1]))
        gx.index_put_((idx,), g)
        return gx, None


def _with_zero_row(parts: List[torch.Tensor]) -> torch.Tensor:
    """The row blocks ``parts`` stacked, with a zero row at the end."""
    zero = parts[0].new_zeros((1, parts[0].shape[1]))
    return torch.cat([*parts, zero])


def _received(send: torch.Tensor, msize: int) -> torch.Tensor:
    """The all-to-all's receive side, ``R_p[s] = S_s[p]``, where every
    source's send buffer is ``send`` (``(msize, cap_send, ...)``: the
    ``model`` peers of a batch shard route its tokens alike): peer p
    receives ``send[p]`` from each of the msize sources, returned peer
    major as ``(msize·msize·cap_send, ...)``."""
    return send.unsqueeze(1).expand(msize, *send.shape).reshape(
        -1, *send.shape[2:])


class _FirstCopy(torch.autograd.Function):
    """Peer 0's copy of the output (``copies[0]`` of the stacked copies)
    forward; backward, every copy takes the cotangent over the copy
    count, as the reference's shard_map transpose hands its output's
    cotangent to each ``model`` peer's copy (an output replicated over
    ``model``, unchecked)."""

    @staticmethod
    def forward(ctx, copies):
        ctx.n = copies.shape[0]
        return copies[0].clone()

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.n).expand(ctx.n, *g.shape)


def _peer_weights(p, mesh: Mesh, x: torch.Tensor, e_loc: int):
    """Each ``model`` peer's expert weights and the device its products run
    on: the slices of leaves placed by ``device_put_params``, each on its
    peer's device, or views of whole leaves on their one device.  Raises
    where the mesh's entries name several devices and the path is not
    ported: whole leaves (``ValueError``: place them), or a batch axis
    above 1 (``NotImplementedError``)."""
    names = EXPERT_LEAVES
    msize = mesh.shape["model"]
    placed = isinstance(p["experts_gate"], PeerSlices)
    several = sharding.several(mesh)
    if several and not placed:
        raise ValueError(
            "moe_layer_ep on a mesh of several devices takes expert weights "
            "placed on their peers' devices: pass the tree through "
            "distributed.sharding.device_put_params(params, mesh) first")
    if several and any(mesh.shape.get(ax, 1) > 1 for ax in ("pod", "data")):
        raise NotImplementedError(
            "moe_layer_ep on a mesh of several devices with a 'data' or "
            "'pod' axis above 1 is not ported yet (ROADMAP queue A item "
            "10.3); bind a (data=1, model=M) mesh")
    if not placed:
        parts = {n: p[n].split(e_loc) for n in names}
        return [({n: parts[n][pe] for n in names}, x.device)
                for pe in range(msize)]
    out = []
    for pe in range(msize):
        w = {n: p[n].parts[pe] if isinstance(p[n], PeerSlices) else None
             for n in names}
        dev = mesh.device_at(model=pe)
        if any(t is None or t.shape[0] != e_loc
               or not _same_device(t.device, dev) for t in w.values()):
            raise ValueError(
                f"the expert weights are not placed for this mesh (peer "
                f"{pe}: {e_loc} experts on {dev}): place them with "
                f"device_put_params under the mesh they run on")
        out.append((w, dev))
    return out


def _ep_forward(p, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """The EP program on the bound mesh: the ``(B, S, D)`` output as each
    ``model`` peer holds it, stacked, peer 0's first; only peer 0's where
    no gradient is taken.  Routing, the send buffers, the grouping and
    the combine run on x's device; each peer's three expert products run
    on its weights' device (:func:`_peer_weights`).  Under a gradient the
    copies carry the cotangent back: each peer's dx and dW run on its
    device, from autograd's worker thread of that device, and a placed
    slice's gradient lands in its own ``.grad`` there."""
    mesh = active_mesh()
    mesh.check_operands(x)
    b, s, d = x.shape
    k = cfg.top_k
    z = ep_sizes(mesh, cfg, b, s)
    msize, e_loc, t_loc = z["msize"], z["e_loc"], z["t_loc"]
    cap_send, cap_exp = z["cap_send"], z["cap_exp"]
    n_buf = e_loc * cap_exp
    bl = b // z["batch_div"]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, p["router"], p["experts_gate"],
                                  p["experts_up"], p["experts_down"]))
    n_src = msize if grad else 1
    peers = _peer_weights(p, mesh, x, e_loc)
    home = x.device
    # peers on other devices compute first: a copy back to x's device
    # waits for what x's device has queued, so its own peers go last
    away = [pe for pe, (_, dev) in enumerate(peers)
            if not _same_device(dev, home)]
    order = away + [pe for pe in range(msize) if pe not in away]
    outs = []
    for i in range(z["batch_div"]):
        x_loc = x[i * bl:(i + 1) * bl].reshape(t_loc, d)
        # every model peer routes the shard's tokens alike: one routing and
        # one send buffer stand for every source's
        r = _ep_route(p["router"], cfg, x_loc, msize, e_loc, cap_send)
        x_send, eid_send = _ep_send(x_loc, r, msize, cap_send)
        # all-to-all out (every one of the msize sources sends its buffers);
        # every peer groups what it received by expert (one batched sort)
        # and runs its experts
        x_send = moved(x_send, "all-to-all", copies=msize)
        eid_send = moved(eid_send, "all-to-all", copies=msize)
        row = _ep_group(_received(eid_send, msize).view(msize, -1), e_loc,
                        cap_exp).reshape(-1)
        buf = x_send.new_zeros((msize * n_buf + 1, d))
        buf.index_put_((row,), _received(x_send, msize))
        # each peer's rows to its device, all enqueued before any product
        # (no copy on x's device); the products then run on every device
        # at once, and each peer's output comes back
        ins = [buf[pe * n_buf:(pe + 1) * n_buf].to(dev)
               for pe, (_, dev) in enumerate(peers)]
        ys = [None] * msize
        for pe in order:
            w, dev = peers[pe]
            with _on(dev):
                ys[pe] = _experts(w, ins[pe], e_loc, cap_exp)
        ys = [y.to(home) for y in ys]
        # the grouping undone: each received slot's row, or zeros, as
        # (peer, source, cap_send, D)
        y_back = moved(_Take.apply(_with_zero_row(ys), row).view(
            msize, msize, cap_send, d), "all-to-all")
        # all-to-all back: source src receives y_back[p][src] from each
        # peer p, for the first n_src sources at once; each token's k
        # gated slots summed in their top-k order
        n = msize * cap_send
        y_recv = _with_zero_row([y_back[:, :n_src].transpose(0, 1)
                                 .reshape(-1, d)])
        src = torch.arange(n_src, device=x.device)[:, None] * n
        idx = torch.where(r["keep"], src + r["slot"], n_src * n)
        y = _Take.apply(y_recv, idx.reshape(-1)).view(n_src, t_loc, k, d) \
            * r["gates"].to(x.dtype).view(1, t_loc, k, 1)
        outs.append(y.sum(dim=2).view(n_src, bl, s, d))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def moe_layer_ep(p, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """Expert-parallel MoE with explicit all-to-all dispatch and combine
    over the bound mesh (the reference's ``moe_layer_ep``): x ``(B, S,
    D)`` → ``(B, S, D)`` on x's device.

    Each batch shard's tokens are routed at every ``model`` peer (the
    reference replicates them over ``model``), each peer's send buffers
    go out in one all-to-all, every peer groups what it received by its
    experts and runs them on B8, and one all-to-all brings the outputs
    back.  Every peer's copy of the output is the same unless a peer
    drops slots at the second level, where the copies of later sources
    lose theirs first; then, as reading the reference's global output
    does, the port returns peer 0's copy, and, as the reference's
    gradient does, the backward hands every copy the cotangent over the
    peer count (:class:`_FirstCopy`).

    FSDP: the reference's expert weights arrive sharded over ``data`` on
    their ``d_model`` axis and are all-gathered inside the layer; in one
    process the weights are whole over ``data`` and nothing is gathered.
    Each peer multiplies by its ``e_loc`` experts: a view of whole leaves
    on a mesh whose every entry is x's device, or its slices of leaves
    placed by ``distributed.sharding.device_put_params``, on its own
    device.  On a mesh of several devices (serving and training across
    cards) each peer's rows of the grouped buffer are copied to its
    device, its three B8 products run there and its output comes back to
    x's device; the backward runs each peer's dx and dW there too.  Whole
    leaves raise ``ValueError`` there, and a batch axis above 1
    ``NotImplementedError`` (ROADMAP queue A item 10.3).
    """
    copies = _ep_forward(p, cfg, x)
    return copies[0] if len(copies) == 1 else _FirstCopy.apply(copies)


def ep_dropped_slots(p, cfg: MoEConfig, x: torch.Tensor) -> Dict[str, int]:
    """The slots :func:`moe_layer_ep` drops on ``x`` under the bound mesh,
    summed over its coordinates: at the first level (a source's slots past
    ``cap_send`` for one destination) and at the second (a peer's
    received slots past ``cap_exp`` for one expert)."""
    mesh = active_mesh()
    b, s, d = x.shape
    z = ep_sizes(mesh, cfg, b, s)
    msize, e_loc, t_loc = z["msize"], z["e_loc"], z["t_loc"]
    bl = b // z["batch_div"]
    first = second = 0
    with torch.no_grad():
        for i in range(z["batch_div"]):
            xt = x[i * bl:(i + 1) * bl].reshape(t_loc, d)
            r = _ep_route(p["router"], cfg, xt, msize, e_loc, z["cap_send"])
            _, eid = _ep_send(xt, r, msize, z["cap_send"])
            first += msize * int((~r["keep"]).sum())
            er = _received(eid, msize).view(msize, -1)
            row = _ep_group(er, e_loc, z["cap_exp"])
            second += int(((er >= 0) & (row == msize * e_loc * z["cap_exp"]))
                          .sum())
    return {"first_level": first, "second_level": second}
