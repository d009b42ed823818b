"""Mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants, so that importing this module
never touches CUDA.

The reference's production topology is a TPU v5e pod of 16 × 16 = 256
chips: ``(data=16, model=16)``, and ``(pod=2, data=16, model=16)`` over
two pods.  The port builds the same grids over the cards this process
sees (:class:`~repro_torch.distributed.sharding.Mesh`, one process, no
``torch.distributed``).  Torch has no forced device count, so a machine
with fewer cards cannot stand in for a pod; the single-process stand-in
that the tests and ``chip_smoke.py`` use is a debug mesh with one device
named at every coordinate (``make_debug_mesh(..., device="cuda")``: every
coordinate's work runs on that card, one after another).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh, local_devices


def _grid(devices: Sequence[torch.device], shape: Tuple[int, ...]):
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """``(data=16, model=16)`` over the first 256 cards, or ``(pod=2,
    data=16, model=16)`` over the first 512 with ``multi_pod``; raises
    ``RuntimeError`` when this process sees fewer cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    devices = local_devices()
    if len(devices) < need:
        found = ", ".join(str(d) for d in devices) or "none"
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, found {len(devices)} "
            f"(cards: {found}) — the production mesh takes one CUDA card "
            f"a coordinate, and torch has no forced device count")
    return Mesh(_grid(devices[:need], shape), axes)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), *,
                    device: Optional[str] = None) -> Mesh:
    """Tiny mesh: over the first ``prod(shape)`` cards (the CPU where
    there are none), or, given ``device``, that one device at every
    coordinate (``"cpu"``, or ``"cuda"``: one card's mesh)."""
    need = math.prod(shape)
    if device is not None:
        return Mesh(_grid([torch.device(device)] * need, tuple(shape)),
                    tuple(axes))
    devices = local_devices() or [torch.device("cpu")]
    if len(devices) < need:
        raise ValueError(f"mesh {tuple(shape)} needs {need} devices, found "
                         f"{len(devices)}: {[str(d) for d in devices]}")
    return Mesh(_grid(devices[:need], tuple(shape)), tuple(axes))
