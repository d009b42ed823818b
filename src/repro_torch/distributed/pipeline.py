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
``mesh.device_at(pod=p)`` (index 0 along every other axis: the reference
replicates a stage over them, and those replicas compute the same
values), ``P · M`` stage calls (the bubbles' outputs are never read, so
they are not computed), and the last stage's outputs come back on
``x``'s device in ``x``'s shape.

On a mesh whose entries name several devices (four cards) each stage's
groups live on their own device: :func:`place_stages` puts them there
once, as the reference's ``jax.device_put(params_stacked,
NamedSharding(mesh, P("pod")))`` does, and :func:`pipeline_apply` takes
only such a tree there (it copies nothing each call).  On a mesh of one
device a stage's groups are moved to it where they lie elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from repro_torch.core.csr import BlockCSR
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Mesh, moved, same_device


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


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor (a BlockCSR's payload;
    its host pattern and per-device metadata cache kept)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, BlockCSR):
        return dataclasses.replace(tree, blocks=fn(tree.blocks),
                                   device_meta=tree.device_meta)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _on_device(tree, device: torch.device):
    """``tree`` with every tensor on ``device`` (no copy where it is)."""
    return _map_tensors(tree, lambda t: t.to(device))


def _per_group(params, n_pods: int, what: str, fn):
    """``params`` with each layer group replaced by ``fn(g, group, p)``,
    ``p`` its stage (``g // (n_groups / P)``): the per-layer list layout
    (a list of per-group subtrees, or dicts of such lists).  A stacked
    leaf (a tensor or BlockCSR outside any list) raises ``ValueError``."""
    per = stage_group_count(_n_groups(params), n_pods)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fn(g, group, g // per)
                              for g, group in enumerate(tree))
        raise ValueError(
            f"{what} takes the per-layer list layout (lm.unstack_layers's), "
            f"one subtree a layer group, placed by place_stages; this tree "
            f"holds a stacked {type(tree).__name__}")
    return walk(params)


def _stage_devices(mesh: Mesh, pod_axis: str) -> List[torch.device]:
    return [mesh.device_at(**{pod_axis: p})
            for p in range(mesh.shape[pod_axis])]


def place_stages(params_stacked, mesh: Mesh, *, pod_axis: str = "pod"):
    """``params_stacked`` placed for :func:`pipeline_apply` on ``mesh``:
    the port's ``jax.device_put(params_stacked, NamedSharding(mesh,
    P(pod_axis)))``.  Takes the per-layer list layout
    (``lm.unstack_layers``'s: a list of per-group subtrees, or dicts of
    such lists); group ``g`` goes to the device of its stage,
    ``mesh.device_at(pod=g // (n_groups / P))``, each tensor a leaf of
    its own there (``requires_grad`` kept), and one already on that
    device is kept as it is, not copied.  A BlockCSR keeps its one host
    pattern.  A stacked leaf raises ``ValueError``."""
    devices = _stage_devices(mesh, pod_axis)

    def put(t: torch.Tensor, device: torch.device) -> torch.Tensor:
        if same_device(t.device, device):
            return t
        return t.detach().to(device).requires_grad_(t.requires_grad)
    return _per_group(params_stacked, len(devices), "place_stages",
                      lambda g, group, p: _map_tensors(
                          group, lambda t: put(t, devices[p])))


def _check_placed(params, devices: List[torch.device]) -> None:
    """Raise ``ValueError`` unless every group of ``params`` lies on its
    stage's device (:func:`place_stages`)."""
    def check(g, group, p):
        def on_stage(t):
            if not same_device(t.device, devices[p]):
                raise ValueError(
                    f"pipeline_apply on a mesh of several devices: layer "
                    f"group {g} holds a tensor on {t.device}, not on stage "
                    f"{p}'s {devices[p]}; place the tree with "
                    f"distributed.pipeline.place_stages(params, mesh) first")
        _map_tensors(group, on_stage)
    _per_group(params, len(devices),
               "pipeline_apply on a mesh of several devices", check)


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

    On a mesh whose entries name several devices ``params_stacked`` must
    be placed (:func:`place_stages`): a group on another device than its
    stage's, or a stacked tree, raises ``ValueError``.  On a mesh of one
    device a stage's groups are moved to it where they lie elsewhere.
    """
    n_pods = mesh.shape[pod_axis]
    m = n_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} vs microbatches {m}")
    several = sharding.several(mesh)
    per = stage_group_count(_n_groups(params_stacked), n_pods)
    devices = _stage_devices(mesh, pod_axis)
    if several:
        _check_placed(params_stacked, devices)
    mesh.check_operands(x)
    stages = [_stage_params(params_stacked, p * per, (p + 1) * per)
              for p in range(n_pods)]
    if not several:
        stages = [_on_device(s, d) for s, d in zip(stages, devices)]
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
