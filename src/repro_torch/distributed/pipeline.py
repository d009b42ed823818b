"""GPipe pipeline parallelism over the ``pod`` mesh axis (port of
``repro.distributed.pipeline``).

Each stage owns ``n_groups / P`` consecutive layer groups (the leading
axis of the stacked parameters, split over the ``P`` coordinates of the
``pod`` axis), and microbatch ``t`` passes stage ``p`` at tick ``t + p``;
each hop of the activation ring moves it onto the next stage's device.
The whole schedule is differentiable: autograd through the hops (a
``.to()`` each) is the reverse ring, so the backward of
:func:`pipeline_apply` gives the sequential gradients.

The reference runs the schedule under ``shard_map``: every stage computes
at every one of the ``M + P - 1`` ticks in lockstep, on zeros in the
pipeline's bubbles, and the last stage's outputs are broadcast over
``pod``.  The port runs the same program coordinate by coordinate in one
process, as ``models.moe.moe_layer_ep`` does: stage ``p`` on
``mesh.device_at(pod=p)``, ``P · M`` stage calls (the bubbles' outputs are
never read, so they are not computed), and the last stage's outputs come
back on ``x``'s device in ``x``'s shape.  A mesh whose coordinates name
several devices raises, as expert parallelism does (ROADMAP queue A
item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from repro_torch.core.csr import BlockCSR
from repro_torch.distributed.sharding import Mesh, moved, one_device


def stage_group_count(n_groups: int, n_pods: int) -> int:
    if n_groups % n_pods:
        raise ValueError(f"{n_groups} layer groups not divisible over "
                         f"{n_pods} pods")
    return n_groups // n_pods


def _n_groups(params) -> int:
    """The length of the stacked leading axis: a list's length (the
    trainer's per-layer layout), else the first array leaf's leading
    dim."""
    if isinstance(params, (list, tuple)):
        return len(params)
    if isinstance(params, dict):
        return _n_groups(next(iter(params.values())))
    if isinstance(params, BlockCSR):
        return params.blocks.shape[0]
    return params.shape[0]


def _stage_params(params, lo: int, hi: int):
    """Groups ``[lo, hi)`` of the stacked tree: a slice of a per-layer
    list, or of every leaf's leading axis (a stacked BlockCSR's payload,
    over the same pattern)."""
    if isinstance(params, (list, tuple)):
        return params[lo:hi]
    if isinstance(params, dict):
        return {k: _stage_params(v, lo, hi) for k, v in params.items()}
    if isinstance(params, BlockCSR):
        return dataclasses.replace(params, blocks=params.blocks[lo:hi],
                                   device_meta=params.device_meta)
    return params[lo:hi]


def _on_device(tree, device: torch.device):
    """``tree`` with every tensor on ``device`` (no copy where it is)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, BlockCSR):
        return dataclasses.replace(tree, blocks=tree.blocks.to(device),
                                   device_meta=tree.device_meta)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def pipeline_apply(stage_fn: Callable, mesh: Mesh, n_microbatches: int,
                   params_stacked, x: torch.Tensor, *,
                   pod_axis: str = "pod") -> torch.Tensor:
    """Run ``x`` through every pipeline stage (GPipe).

    ``stage_fn(stage_params, x_mb) → y_mb`` applies one stage's layer
    groups; ``stage_params`` is ``params_stacked`` cut to the stage's
    ``n_groups / P`` groups: a slice of each leaf's leading axis, or of
    the list where ``params_stacked`` is a list of per-group subtrees
    (``lm.unstack_layers``'s layout, so that each group's gradient is a
    tensor of its own).  ``x``: ``(batch, ...)`` with the batch divisible
    by ``n_microbatches``.  Returns the last stage's output, ``x``'s
    shape (``stage_fn`` keeps a microbatch's shape), on ``x``'s device.
    """
    n_pods = mesh.shape[pod_axis]
    m = n_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} vs microbatches {m}")
    one_device(mesh, "pipeline_apply")
    mesh.check_operands(x)
    per = stage_group_count(_n_groups(params_stacked), n_pods)
    devices = [mesh.device_at(**{pod_axis: p}) for p in range(n_pods)]
    stages = [_on_device(_stage_params(params_stacked, p * per,
                                       (p + 1) * per), devices[p])
              for p in range(n_pods)]
    xs = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    inbox: List = [None] * n_pods       # the activation entering each stage
    outs: List = [None] * m
    for t in range(m + n_pods - 1):
        # last stage first, so that a send lands after its receiver's
        # input of this tick was taken
        for p in reversed(range(n_pods)):
            mb = t - p
            if not 0 <= mb < m:
                continue                # a bubble: nothing reads it
            x_in = xs[mb].to(devices[0]) if p == 0 else inbox[p]
            y = stage_fn(stages[p], x_in)
            if p == n_pods - 1:
                outs[mb] = y
            else:                       # the ring: p → p + 1
                inbox[p + 1] = moved(y, "collective-permute").to(
                    devices[p + 1])
    # the reference broadcasts the last stage's outputs over pod (a psum);
    # here they come back to x's device once
    y = moved(torch.stack(outs), "all-reduce").to(x.device)
    return y.reshape(x.shape)
