"""Training step: gradient accumulation over microbatches plus the AdamW
update (port of ``repro.train.train_step``).

Over several microbatches the gradients accumulate in
``cfg.grad_accum_dtype``, as the reference's ``acc + grad.astype(acc_dt)
/ n``.  Where every parameter already has that dtype (f32 parameters and
the default f32 accumulator) the accumulator is each parameter's
``.grad``: every microbatch runs ``backward`` on ``loss / n``, and no
second copy of the gradients is kept.  Otherwise (the giant configs'
bf16 accumulator) each microbatch's gradient is added into a buffer of
that dtype and ``.grad`` is cleared.  Parameters may be f32 or bf16:
their gradients come in their dtype and the optimizer widens them leaf by
leaf, as the reference's.  Sparse-container metadata
is host numpy and never part of the autograd graph, so no partition of
trainable leaves is needed.  Hold the parameters in the per-layer layout
(``lm.unstack_layers``) so that each layer's gradient is a tensor of its
own.

The reference compiles its step once, ``jax.jit(make_train_step(...))``;
:func:`jitted_train_step` is the port's counterpart.  On the card the
whole step (the forward with its remat, the hand-written backward, the
microbatch accumulation, the global-norm clip and AdamW) is captured
once as a CUDA graph and replayed (:class:`CapturedTrainStep`); on the
CPU, and under a bound mesh whose entries name several cards, it is the
eager step.

The step takes a tree whose expert leaves were placed over a mesh's
``model`` peers (``sharding.device_put_params``; the MoE layer's
expert-parallel path under that mesh): each peer's dx and dW run on its
peer's card, from autograd's worker thread of that card, each slice's
gradient lands in its own ``.grad`` there, and AdamW updates it there.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serve.graphs import StepGraph, captured
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         apply_updates, named_leaves, parts,
                                         tree_map)


def _split_microbatches(batch: Dict[str, torch.Tensor],
                        n: int) -> List[Dict[str, torch.Tensor]]:
    """(B, ...) → n batches of (B/n, ...)."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by {n} "
                             f"microbatches")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    micro_batches: int | None = None, mlp_plan=None):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``.  ``params`` and ``opt_state`` are updated in place and
    returned.  ``mlp_plan`` is the shared ``SpmmTrainPlan`` of a
    sparse-MLP model (``lm.sparse_mlp_plan(params)``, built once); the
    step carries it, and ``cfg``, as attributes."""
    n_micro = micro_batches or cfg.train_microbatches
    acc_dt = getattr(torch, cfg.grad_accum_dtype)

    def loss_of(params, mb):
        return lm.loss_fn(params, cfg, mb, remat=cfg.remat,
                          mlp_plan=mlp_plan)

    def train_step(params, opt_state: OptState, batch):
        leaves = [t for _, leaf in named_leaves(params) for t in parts(leaf)]
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        in_grad = all(t.dtype == acc_dt for t in leaves)
        acc = {}
        if n_micro == 1:
            loss, metrics = loss_of(params, batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = None
            for mb in _split_microbatches(batch, n_micro):
                mb_loss, _ = loss_of(params, mb)
                if in_grad:
                    (mb_loss / n_micro).backward()
                else:
                    mb_loss.backward()
                    for t in leaves:
                        g = t.grad.to(acc_dt) / n_micro
                        if id(t) in acc:
                            acc[id(t)].add_(g)
                        else:
                            acc[id(t)] = g
                        t.grad = None
                part = mb_loss.detach() / n_micro
                loss = part if loss is None else loss + part
            metrics = {}
        grads = tree_map(lambda t: acc[id(t)] if acc else t.grad, params)
        params, opt_state, opt_metrics = apply_updates(opt_cfg, params,
                                                       grads, opt_state)
        for t in leaves:
            t.grad = None
        out = {"loss": loss, **opt_metrics}
        out.update({k: v for k, v in metrics.items() if k != "loss"})
        return params, opt_state, out

    train_step.cfg, train_step.mlp_plan = cfg, mlp_plan
    return train_step


class CapturedTrainStep:
    """A built ``train_step`` on the card, called as it is:
    ``fn(params, opt_state, batch) → (params, opt_state, metrics)``.

    It runs through :attr:`graph` (a :class:`StepGraph` with autograd
    on): the first call on a set of parameters and optimizer state is the
    eager step (the warm-up), the next captures the whole step and
    replays it, and every later one copies the batch's tensors (tokens,
    labels and the config's extra inputs) into the graph's buffers and
    replays.  The graph holds the parameters, the optimizer state and the
    step's ``mlp_plan``; handed other tensors (a checkpoint's, say) it
    warms up and captures again.  The step updates ``params`` and
    ``opt_state`` in place, so it returns the objects it was handed; only
    the metrics are fresh tensors."""

    def __init__(self, train_step, device):
        self.train_step = train_step
        self.device = torch.device(device)
        self.graph = StepGraph(f"the train step of {train_step.cfg.name}",
                               grad=True)

    def __call__(self, params, opt_state, batch):
        if not captured(self.device):
            return self.train_step(params, opt_state, batch)

        def fn(feeds):
            return self.train_step(params, opt_state, feeds)[2]

        metrics = self.graph(fn, batch,
                             (params, opt_state, self.train_step.mlp_plan),
                             self.device)
        return params, opt_state, metrics


def jitted_train_step(train_step, device):
    """The counterpart of the reference's ``jax.jit(make_train_step(...))``
    for a built ``train_step``: on a CUDA ``device`` a
    :class:`CapturedTrainStep`, elsewhere, and under a bound mesh whose
    entries name several cards (``serve.graphs.captured``: capture across
    cards waits in ROADMAP's work held for after the first benchmark, item
    10.2), ``train_step`` itself."""
    if not captured(torch.device(device)):
        return train_step
    return CapturedTrainStep(train_step, device)
