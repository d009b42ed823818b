"""AdamW with decoupled weight decay, global-norm clipping, a cosine
schedule with warmup and optional int8 gradient compression with error
feedback (port of ``repro.train.optimizer``).

A parameter tree is nested dicts and lists of tensors, with
:class:`~repro_torch.core.csr.BlockCSR` leaves whose payload is the
weight and whose host metadata is structure, never updated.
:func:`named_leaves` names each trainable tensor by its path (``"/"``
between keys and list indices; a sparse payload as ``<path>/blocks``),
and the optimizer state keys its moments by those paths.  Weight decay
is chosen from the path by the reference's tokens.

An MoE expert leaf placed over a mesh's ``model`` peers
(:class:`~repro_torch.distributed.sharding.PeerSlices`, from
``sharding.device_put_params``) is one leaf under the whole leaf's path:
its gradient and moments are ``PeerSlices`` cut alike, each slice on its
peer's device, and each slice is updated on its own device.  The global
norm sums the squares on the device of the first leaf, leaf by leaf and
a placed leaf's slices in peer order; that order is the one difference
between a placed tree's step and the whole tree's.

The update runs in place: parameters and moments are overwritten leaf by
leaf, with the f32 temporaries of one leaf at a time (the reference
returns new arrays; in place keeps one copy of each on the card).  The
state it returns is the state it was given: the step count is
incremented in place and each error-feedback residual is rewritten in
its own buffer, so a step captured as a CUDA graph replays onto the
same tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import torch

from repro_torch.core.csr import BlockCSR
from repro_torch.distributed.sharding import PeerSlices


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: Any = torch.float32     # torch.bfloat16 for giant configs
    # int8 gradient compression (error feedback keeps it unbiased-ish)
    compress_grads: bool = False


class OptState(NamedTuple):
    step: torch.Tensor               # () int32
    m: Dict[str, torch.Tensor]       # path -> first moment
    v: Dict[str, torch.Tensor]       # path -> second moment (f32)
    error: Dict[str, torch.Tensor]   # path -> error-feedback residual
    #                                  (a () zero when compression is off)


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, tensor)`` for every floating-point tensor of ``tree``, in
    a fixed order, and ``(path, PeerSlices)`` for a placed leaf; sparse
    metadata is skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(tree, BlockCSR):
        yield f"{prefix}/blocks", tree.blocks
    elif isinstance(tree, PeerSlices) or (isinstance(tree, torch.Tensor)
                                          and tree.is_floating_point()):
        yield prefix, tree


def parts(leaf) -> Tuple[torch.Tensor, ...]:
    """A leaf's tensors: a placed leaf's slices in peer order, else the
    tensor itself."""
    return leaf.parts if isinstance(leaf, PeerSlices) else (leaf,)


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``tree`` with ``fn`` applied to every floating-point tensor (a
    BlockCSR keeps its metadata and gets ``fn(blocks)`` as payload; a
    placed leaf keeps its cut and gets ``fn`` of each slice)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, BlockCSR):
        return dataclasses.replace(tree, blocks=fn(tree.blocks))
    if isinstance(tree, PeerSlices):
        return tree.map(fn)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _zeros_like(leaf, dtype):
    """Zeros of ``leaf``'s shape in ``dtype`` on its device (a placed
    leaf: on each slice's)."""
    if isinstance(leaf, PeerSlices):
        return leaf.map(lambda t: torch.zeros_like(t, dtype=dtype))
    return torch.zeros_like(leaf, dtype=dtype)


def init_opt_state(cfg: OptimizerConfig, params) -> OptState:
    leaves = list(named_leaves(params))
    dev = parts(leaves[0][1])[0].device if leaves else torch.device("cpu")
    m = {k: _zeros_like(p, cfg.m_dtype) for k, p in leaves}
    v = {k: _zeros_like(p, torch.float32) for k, p in leaves}
    if cfg.compress_grads:
        err = {k: _zeros_like(p, torch.float32) for k, p in leaves}
    else:
        err = {k: torch.zeros((), dtype=torch.float32,
                              device=parts(p)[0].device)
               for k, p in leaves}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=m, v=v, error=err)


def _compress_int8(gs, errs):
    """Symmetric per-tensor int8 quantization with error feedback, of a
    leaf's slices ``gs`` (f32) and their residuals ``errs``: one scale
    over the whole leaf, from the slices' largest magnitudes taken in peer
    order on the first slice's device.  Returns the dequantized slices
    and their new residuals."""
    gs = [g + e for g, e in zip(gs, errs)]
    home = gs[0].device
    peak = torch.max(torch.stack([torch.max(torch.abs(g)).to(home)
                                  for g in gs]))
    scale = torch.clamp(peak, min=1e-12) / 127.0
    out = []
    for g in gs:
        s = scale.to(g.device)
        deq = torch.clamp(torch.round(g / s), -127, 127).to(
            torch.int8).float() * s
        out.append((deq, g - deq))
    return out


def global_norm(tree) -> torch.Tensor:
    """The square root of every gradient's sum of squares, summed on the
    first leaf's device in :func:`named_leaves` order (a placed leaf's
    slices in peer order)."""
    total = None
    for _, leaf in named_leaves(tree):
        for g in parts(leaf):
            sq = torch.sum(torch.square(g.float()))
            if total is None:
                total = sq
            else:
                total = total + sq.to(total.device)
    return torch.sqrt(total) if total is not None else torch.zeros(())


def _decayable(path: str) -> bool:
    """No weight decay on norms / biases / 1-d gates."""
    for token in ("norm", "bias", "lambda", "a_log", "d_skip", "dt_bias",
                  "scale"):
        if token in path:
            return False
    return True


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state: OptState):
    """One AdamW step on ``params`` and ``state`` in place (``grads`` a
    tree of the same structure); returns ``(params, state, {"lr",
    "grad_norm"})``, the same ``params`` and ``state`` objects."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    step = state.step.add_(1)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    scalars = {state.step.device: (clip, lr, b1c, b2c)}
    flat_g = dict(named_leaves(grads))
    for path, p in named_leaves(params):
        ps, gs = parts(p), parts(flat_g[path])
        ms, vs = parts(state.m[path]), parts(state.v[path])
        if cfg.compress_grads:
            errs = parts(state.error[path])
            pairs = _compress_int8([g.float() for g in gs], errs)
            for e, (_, err) in zip(errs, pairs):
                e.copy_(err)
            g32s = [deq for deq, _ in pairs]
            del pairs
        else:
            g32s = [g.float() for g in gs]
        for i, (w, m, v) in enumerate(zip(ps, ms, vs)):
            if w.device not in scalars:     # a peer's slice on its device
                scalars[w.device] = tuple(
                    t.to(w.device) for t in scalars[state.step.device])
            c, lr_w, b1c_w, b2c_w = scalars[w.device]
            g32, g32s[i] = g32s[i] * c, None
            m32 = m if m.dtype == torch.float32 else m.float()
            m32.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            if m32 is not m:
                m.copy_(m32)
            v.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
            del g32
            denom = (v / b2c_w).sqrt_().add_(cfg.eps)
            update = (m32 / b1c_w).div_(denom)
            del denom, m32
            if cfg.weight_decay and _decayable(path):
                update.add_(cfg.weight_decay * w.float())
            if w.dtype == torch.float32:
                w.sub_(update.mul_(lr_w))
            else:
                w.copy_(w.float() - update.mul_(lr_w))
            del update
    return params, state, {"lr": lr, "grad_norm": gnorm}
