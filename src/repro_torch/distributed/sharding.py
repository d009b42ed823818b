"""The device mesh (the mesh part of ``repro.distributed.sharding``): a
bound-mesh context, the axis names, and ``partition_mesh`` with the
reference's resolution order and raises.

The reference's mesh is a ``jax.sharding.Mesh`` over
``jax.local_devices()``, in one process.  The port's is one process too: a
:class:`Mesh` is a grid of ``torch.device`` s with named axes, and the
code that runs on it places each coordinate's work on that coordinate's
device (:meth:`Mesh.device_at`) and brings the results back.  The
partitioned Maple kernels (``kernels.ops``) take a ``(PARTITION_AXIS,
COL_AXIS)`` grid; the expert-parallel MoE layer (``models.moe``) takes
the production meshes' ``("data", "model")`` and ``("pod", "data",
"model")`` grids (``launch.mesh``).  There are no process groups: like the
reference, nothing here needs ``torch.distributed``.  The logical-axis
rules, ``shard`` and the parameter and state specs of the reference
module are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

# the partitioned Maple kernels' mesh axes: PARTITION_AXIS splits the
# block-rows (plan metadata and payload), COL_AXIS the dense operand's N
PARTITION_AXIS = "shard"
COL_AXIS = "col"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices with named axes, one array axis per name:
    ``devices`` (nested lists or an array of ``torch.device`` s or device
    strings) is kept as an object array of ``torch.device`` s."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        grid = np.asarray(self.devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [torch.device(d) for d in grid.reshape(-1)]
        object.__setattr__(self, "devices", flat.reshape(grid.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"{grid.ndim}-D device grid for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_at(self, **coords: int) -> torch.device:
        """The device at the named coordinates, e.g. ``device_at(data=1,
        model=3)``: index 0 along every axis not named; an axis the mesh
        lacks, or an index outside its axis, raises."""
        idx = [0] * len(self.axis_names)
        for axis, i in coords.items():
            if axis not in self.axis_names:
                raise KeyError(f"mesh axes {self.axis_names} have no "
                               f"{axis!r}")
            n = self.devices.shape[self.axis_names.index(axis)]
            if not 0 <= i < n:
                raise IndexError(f"{axis}={i} outside the mesh's {n}")
            idx[self.axis_names.index(axis)] = i
        return self.devices[tuple(idx)]

    def device(self, shard: int, col: int = 0) -> torch.device:
        """The device at ``shard`` along ``PARTITION_AXIS`` and ``col``
        along ``COL_AXIS`` (index 0 along any other axis)."""
        coords = {PARTITION_AXIS: shard}
        if col:
            coords[COL_AXIS] = col
        return self.device_at(**coords)

    def check_operands(self, *operands: torch.Tensor) -> None:
        """Raise unless every device of the mesh has the operands' device
        type: card tensors never send a coordinate's work to the CPU (nor
        CPU tensors to a card)."""
        types = {t.device.type for t in operands}
        for dev in self.devices.reshape(-1):
            if types != {dev.type}:
                raise ValueError(
                    f"the bound mesh holds {dev} but the operands are on "
                    f"{sorted(types)}: a mesh runs its coordinates on "
                    f"devices of the operands' type")


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.partition_disabled: bool = False


_ctx = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Bind ``mesh`` for the block (the reference's ``use_mesh_rules``,
    reduced to the mesh: the logical-axis rules are not ported).  Any
    mesh binds; what reads it decides whether its axes apply
    (``partition_mesh`` reuses one with a ``PARTITION_AXIS``, the MoE
    layer takes expert parallelism on one with a ``"model"`` axis)."""
    prev = _ctx.mesh
    _ctx.mesh = mesh
    try:
        yield
    finally:
        _ctx.mesh = prev


def active_mesh() -> Optional[Mesh]:
    return _ctx.mesh


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint``: the forward runs
    as it is; the recompute in the backward runs under the mesh and the
    partition switch that were bound when the forward ran.  The binding
    is per thread, and on CUDA the backward runs on autograd's own
    thread, where a recompute would otherwise see no mesh and take
    another path than the forward did."""
    mesh, disabled = _ctx.mesh, _ctx.partition_disabled

    @contextlib.contextmanager
    def rebound():
        prev = (_ctx.mesh, _ctx.partition_disabled)
        _ctx.mesh, _ctx.partition_disabled = mesh, disabled
        try:
            yield
        finally:
            _ctx.mesh, _ctx.partition_disabled = prev
    return contextlib.nullcontext(), rebound()


def local_devices() -> List[torch.device]:
    """The cards this process sees (none without CUDA)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def partition_mesh(n_shards: int, n_col_shards: int = 1,
                   ) -> Tuple[Optional[Mesh],
                              Optional[Union[str, Tuple[str, str]]]]:
    """Mesh for a :class:`~repro_torch.kernels.partition
    .PartitionedSpmmPlan`: ``(mesh, axes)`` with ``axes`` the
    ``PARTITION_AXIS`` name for a 1-D request, the ``(PARTITION_AXIS,
    COL_AXIS)`` pair for a 2-D one.  The reference's resolution order:

    1. ``n_shards · n_col_shards <= 1``, or inside
       :func:`local_partition_execution` — no mesh: the executor runs the
       stacked loop on the operands' device;
    2. a bound mesh (:func:`use_mesh`) with a ``PARTITION_AXIS`` is
       reused; one of the wrong size, or without the ``COL_AXIS`` a 2-D
       request needs, raises (never a silent private mesh on other
       devices than the caller reserved);
    3. a private mesh over the first ``n_shards · n_col_shards`` cards,
       where ``torch.cuda.device_count()`` has that many;
    4. otherwise ``(None, None)``: the stacked loop, which computes the
       same bits.
    """
    if n_col_shards < 1:
        raise ValueError(f"n_col_shards={n_col_shards} < 1")
    total = n_shards * n_col_shards
    if total <= 1 or _ctx.partition_disabled:
        return None, None
    axes = (PARTITION_AXIS, COL_AXIS) if n_col_shards > 1 else PARTITION_AXIS
    ctx = _ctx.mesh
    if ctx is not None and PARTITION_AXIS in ctx.shape:
        if ctx.shape[PARTITION_AXIS] != n_shards:
            raise ValueError(
                f"bound mesh carries a {PARTITION_AXIS!r} axis of "
                f"{ctx.shape[PARTITION_AXIS]} devices but the plan wants "
                f"n_shards={n_shards} — rebind a matching mesh or drop "
                f"the {PARTITION_AXIS!r} axis to let partition_mesh build "
                f"a private one")
        if n_col_shards > 1:
            if COL_AXIS not in ctx.shape:
                raise ValueError(
                    f"bound mesh reserves {PARTITION_AXIS!r} but has no "
                    f"{COL_AXIS!r} axis, and the plan wants "
                    f"n_col_shards={n_col_shards} column panels — bind a "
                    f"2-D ({PARTITION_AXIS!r}, {COL_AXIS!r}) mesh")
            if ctx.shape[COL_AXIS] != n_col_shards:
                raise ValueError(
                    f"bound mesh carries a {COL_AXIS!r} axis of "
                    f"{ctx.shape[COL_AXIS]} devices but the plan wants "
                    f"n_col_shards={n_col_shards}")
        return ctx, axes
    devices = local_devices()
    if len(devices) < total:
        return None, None
    if n_col_shards > 1:
        grid = [devices[d * n_col_shards:(d + 1) * n_col_shards]
                for d in range(n_shards)]
        return Mesh(grid, (PARTITION_AXIS, COL_AXIS)), axes
    return Mesh(devices[:n_shards], (PARTITION_AXIS,)), axes


@contextlib.contextmanager
def local_partition_execution():
    """Run partitioned plans as the stacked loop even where a mesh is
    available; the loop runs the same per-shard kernels and merge, so the
    results are the mesh path's bits (what the tests pin)."""
    prev = _ctx.partition_disabled
    _ctx.partition_disabled = True
    try:
        yield
    finally:
        _ctx.partition_disabled = prev
