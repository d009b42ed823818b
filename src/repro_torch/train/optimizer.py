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


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every floating-point tensor of ``tree``, in
    a fixed order; sparse metadata is skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(tree, BlockCSR):
        yield f"{prefix}/blocks", tree.blocks
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield prefix, tree


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``tree`` with ``fn`` applied to every floating-point tensor (a
    BlockCSR keeps its metadata and gets ``fn(blocks)`` as payload)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, BlockCSR):
        return dataclasses.replace(tree, blocks=fn(tree.blocks))
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


def init_opt_state(cfg: OptimizerConfig, params) -> OptState:
    leaves = list(named_leaves(params))
    dev = leaves[0][1].device if leaves else torch.device("cpu")
    m = {k: torch.zeros_like(p, dtype=cfg.m_dtype) for k, p in leaves}
    v = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in leaves}
    if cfg.compress_grads:
        err = {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in leaves}
    else:
        err = {k: torch.zeros((), dtype=torch.float32, device=p.device)
               for k, p in leaves}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=m, v=v, error=err)


def _compress_int8(g, err):
    """Symmetric per-tensor int8 quantization with error feedback."""
    g = g + err
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq


def global_norm(tree) -> torch.Tensor:
    total = None
    for _, g in named_leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
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
    flat_g = dict(named_leaves(grads))
    for path, p in named_leaves(params):
        m, v = state.m[path], state.v[path]
        g32 = flat_g[path].float()
        if cfg.compress_grads:
            g32, err = _compress_int8(g32, state.error[path])
            state.error[path].copy_(err)
            del err
        g32 = g32 * clip
        m32 = m if m.dtype == torch.float32 else m.float()
        m32.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        if m32 is not m:
            m.copy_(m32)
        v.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
        del g32
        denom = (v / b2c).sqrt_().add_(cfg.eps)
        update = (m32 / b1c).div_(denom)
        del denom, m32
        if cfg.weight_decay and _decayable(path):
            update.add_(cfg.weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(update.mul_(lr))
        else:
            p.copy_(p.float() - update.mul_(lr))
    return params, state, {"lr": lr, "grad_norm": gnorm}
