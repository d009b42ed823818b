"""The device mesh, the logical-axis sharding rules and the ``shard``
activation hint (port of ``repro.distributed.sharding``).

The reference's mesh is a ``jax.sharding.Mesh`` over
``jax.local_devices()``, in one process.  The port's is one process too: a
:class:`Mesh` is a grid of ``torch.device`` s with named axes, and the
code that runs on it places each coordinate's work on that coordinate's
device (:meth:`Mesh.device_at`) and brings the results back.  The
partitioned Maple kernels (``kernels.ops``) take a ``(PARTITION_AXIS,
COL_AXIS)`` grid; the expert-parallel MoE layer (``models.moe``) takes
the production meshes' ``("data", "model")`` and ``("pod", "data",
"model")`` grids (``launch.mesh``).  There are no process groups: like the
reference, nothing here needs ``torch.distributed``.

:func:`device_put_params` is the port's ``jax.device_put(params,
param_shardings(params, mesh))``: each MoE expert leaf cut into the
``model`` peers' slices (:class:`PeerSlices`), each slice on its peer's
device, every other leaf on the mesh's first device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# the partitioned Maple kernels' mesh axes: PARTITION_AXIS splits the
# block-rows (plan metadata and payload), COL_AXIS the dense operand's N
PARTITION_AXIS = "shard"
COL_AXIS = "col"

AxisNames = Union[str, Tuple[str, ...], None]

# default logical → mesh binding (single- and multi-pod; mesh axes a mesh
# lacks are dropped, so "pod" is harmless on the single-pod mesh)
DEFAULT_RULES: Mapping[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),                 # replicated by default; prefill may use model
    "kv_seq": ("model",),      # decode KV cache sequence axis
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "embed": ("data",),        # FSDP axis for parameters
    "embed_tp": ("model",),    # TP side of 2D-sharded giant params
    "state": ("model",),       # SSM / RG-LRU width
}

# serving: DEFAULT_RULES without the FSDP sharding of parameters over
# `data` (no optimizer state; `data` carries the batch only)
INFERENCE_RULES: Mapping[str, Tuple[str, ...]] = dict(
    DEFAULT_RULES, embed=(), embed_tp=("model",))

# weight-replicated sequence parallelism for serving small models
# (prefill): activations shard their sequence over `model`, parameters
# are replicated, MoE experts still partition over `model`
PREFILL_SP_RULES: Mapping[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    "kv_seq": ("model",),
    "heads": (),
    "kv_heads": (),
    "mlp": (),
    "experts": ("model",),
    "vocab": (),
    "embed": (),
    "embed_tp": (),
    "state": (),
}


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

    @property
    def size(self) -> int:
        return int(self.devices.size)

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


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh with no devices (the reference's ``AbstractMesh``): named
    axis sizes, which is all the rule checks read."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    """A mesh of ``axis_sizes`` over ``axis_names`` with no devices, for
    rule checks (divisibility, spec selection)."""
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for axes {axis_names}")
    return AbstractMesh(tuple(int(n) for n in axis_sizes),
                        tuple(axis_names))


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry a dimension, each
    ``None`` (replicated), a mesh axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A leaf's layout: ``spec`` over ``mesh``'s named axes."""

    mesh: Union[Mesh, AbstractMesh]
    spec: PartitionSpec


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Mapping[str, Tuple[str, ...]] = DEFAULT_RULES
        self.partition_disabled: bool = False


_ctx = _Ctx()


@contextlib.contextmanager
def use_mesh_rules(mesh: Optional[Mesh],
                   rules: Optional[Mapping[str, Tuple[str, ...]]] = None):
    """Bind ``mesh`` and the logical-axis ``rules`` (default
    :data:`DEFAULT_RULES`) for the block.  Any mesh binds; what reads it
    decides whether its axes apply (``partition_mesh`` reuses one with a
    ``PARTITION_AXIS``, the MoE layer takes expert parallelism on one
    with a ``"model"`` axis, the specs read its axis sizes).  The
    reference also clears jax's trace caches when the bound mesh changes;
    the port has no trace cache."""
    prev = (_ctx.mesh, _ctx.rules)
    _ctx.mesh = mesh
    _ctx.rules = dict(rules) if rules is not None else DEFAULT_RULES
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def use_mesh(mesh: Optional[Mesh]):
    """:func:`use_mesh_rules` with :data:`DEFAULT_RULES`."""
    return use_mesh_rules(mesh)


def active_mesh() -> Optional[Mesh]:
    return _ctx.mesh


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint``: the forward runs
    as it is; the recompute in the backward runs under the mesh, the
    rules and the partition switch that were bound when the forward ran.
    The binding is per thread, and on CUDA the backward runs on
    autograd's own thread, where a recompute would otherwise see no mesh
    and take another path than the forward did."""
    bound = (_ctx.mesh, _ctx.rules, _ctx.partition_disabled)

    @contextlib.contextmanager
    def rebound():
        prev = (_ctx.mesh, _ctx.rules, _ctx.partition_disabled)
        _ctx.mesh, _ctx.rules, _ctx.partition_disabled = bound
        try:
            yield
        finally:
            _ctx.mesh, _ctx.rules, _ctx.partition_disabled = prev
    return contextlib.nullcontext(), rebound()


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two device names are one device (``"cuda"`` is the current
    card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    if a.index is not None and b.index is not None:
        return False
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def mesh_devices(mesh) -> List[torch.device]:
    """The distinct devices that ``mesh``'s entries name, in the order
    first met (:func:`same_device`: ``"cuda"`` and the current card's
    ``"cuda:i"`` are one)."""
    out: List[torch.device] = []
    for dev in mesh.devices.reshape(-1):
        if not any(same_device(dev, seen) for seen in out):
            out.append(dev)
    return out


def several(mesh) -> bool:
    """Whether ``mesh``'s entries name several devices (a mesh of several
    cards): the one test by which the pipeline, the MoE layer and capture
    choose their paths.  A mesh with no devices (:class:`AbstractMesh`)
    raises ``ValueError``."""
    if getattr(mesh, "devices", None) is None:
        raise ValueError("an abstract mesh holds no devices")
    return len(mesh_devices(mesh)) > 1


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
    2. a bound mesh (:func:`use_mesh_rules`) with a ``PARTITION_AXIS`` is
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


# --------------------------------------------------------------------------
# logical axes → mesh axes
# --------------------------------------------------------------------------

def _mesh_axes_for(logical: AxisNames, mesh) -> Optional[Tuple[str, ...]]:
    """Resolve one logical name to the mesh axes that exist on this mesh."""
    if logical is None:
        return None
    names = (logical,) if isinstance(logical, str) else logical
    out = []
    for nm in names:
        for ax in _ctx.rules.get(nm, ()):
            if ax in mesh.shape:
                out.append(ax)
    return tuple(out) or None


def _axes_size(axes: Optional[Tuple[str, ...]], mesh) -> int:
    return math.prod(mesh.shape[ax] for ax in axes) if axes else 1


def logical_spec(dims: Sequence[AxisNames], shape: Sequence[int],
                 mesh) -> PartitionSpec:
    """A :class:`PartitionSpec` for ``dims`` (logical names, one a
    dimension) under the bound rules, dropping the mesh axes that do not
    divide a dimension and any axis an earlier dimension took."""
    used = set()
    spec = []
    for logical, dim in zip(dims, shape):
        axes = _mesh_axes_for(logical, mesh)
        if axes:
            axes = tuple(a for a in axes if a not in used)
        if axes and dim % _axes_size(axes, mesh) == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def shard(x: torch.Tensor, dims: Sequence[AxisNames]) -> torch.Tensor:
    """The activation sharding hint: ``x`` itself.  Outside a bound mesh
    nothing is checked; under one, ``dims`` must name every dimension (a
    rank mismatch raises ``ValueError``, as the reference's).  In one
    process a layout places nothing, so the models do not call it."""
    mesh = _ctx.mesh
    if mesh is None:
        return x
    if len(dims) != x.dim():
        raise ValueError(f"{len(dims)} names for rank-{x.dim()} array")
    return x


# --------------------------------------------------------------------------
# parameter rules (path pattern → logical dims)
# --------------------------------------------------------------------------

# ordered: first match wins.  Entries name the trailing dims; stacked
# layer-group leading dims are found by rank and get None.
_PARAM_PATTERNS = (
    ("embed_tokens", ("vocab", "embed")),
    ("lm_head", ("vocab", "embed")),
    ("wq", ("embed", "heads", None)),
    ("wk", ("embed", "kv_heads", None)),
    ("wv", ("embed", "kv_heads", None)),
    ("wo", ("heads", None, "embed")),
    ("w_gate", ("embed", "mlp")),
    ("w_up", ("embed", "mlp")),
    ("w_down", ("mlp", "embed")),
    ("w_in", ("embed", "mlp")),
    ("w_out", ("mlp", "embed")),
    ("experts_gate", ("experts", "embed", None)),
    ("experts_up", ("experts", "embed", None)),
    ("experts_down", ("experts", None, "embed")),
    ("router", ("embed", None)),
    ("in_proj", ("embed", "state")),
    ("out_proj", ("state", "embed")),
    ("conv", (None, "state")),
    ("lru_input", ("embed", "state")),
    ("lru_a_gate", ("state", "state")),
    ("lru_x_gate", ("state", "state")),
    ("vis_proj", (None, "embed")),
)


def _fit(dims: Tuple[AxisNames, ...], rank: int) -> Tuple[AxisNames, ...]:
    """Pattern dims for a leaf of ``rank``: leading stacked dims None,
    or only the trailing ones."""
    if len(dims) < rank:
        return (None,) * (rank - len(dims)) + tuple(dims)
    return tuple(dims[-rank:]) if len(dims) > rank else tuple(dims)


def spec_for_param(path: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """PartitionSpec for one parameter, matched by its path string."""
    if len(shape) == 0:
        return PartitionSpec()
    for pat, dims in _PARAM_PATTERNS:
        if pat in path:
            return logical_spec(_fit(dims, len(shape)), shape, mesh)
    return PartitionSpec()          # norms, biases, gates: replicated


# --------------------------------------------------------------------------
# decode-state (KV cache / recurrent state) rules
# --------------------------------------------------------------------------

_STATE_PATTERNS = (
    ("cross_k", (None, "batch", "kv_seq", None, None)),
    ("cross_v", (None, "batch", "kv_seq", None, None)),
    ("k", (None, "batch", "kv_seq", None, None)),
    ("v", (None, "batch", "kv_seq", None, None)),
    ("conv", (None, "batch", None, "state")),
    ("state", (None, "batch", "state", None, None)),
    ("h", (None, "batch", "state")),
)


def spec_for_state(path: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """PartitionSpec for one decode-state leaf (stacked ``(G, ...)``
    caches), matched on the path's last element: KV caches shard the
    batch over ``data`` and the cache's sequence over ``model``,
    recurrent states their width over ``model``."""
    if len(shape) == 0:
        return PartitionSpec()
    leaf = path.rsplit("/", 1)[-1]
    for pat, dims in _STATE_PATTERNS:
        if leaf == pat or leaf.startswith(pat):
            return logical_spec(_fit(dims, len(shape)), shape, mesh)
    return PartitionSpec()


# --------------------------------------------------------------------------
# trees of shardings
# --------------------------------------------------------------------------

_BSR_FIELDS = ("blocks", "block_col", "block_row", "row_ptr")


def _is_bsr(node) -> bool:
    return all(hasattr(node, f) for f in _BSR_FIELDS) and \
        hasattr(node, "block_shape")


def _key_str(key, style: str) -> str:
    """One path element as the reference's ``jax.tree_util`` key prints:
    ``str(k)`` for parameters (``['name']``, ``[0]``, ``.field``, a
    BlockCSR child ``[<flat index 0>]``) with ``style="str"``;
    ``str(getattr(k, "key", k))`` for states with ``"key"`` (a dict key
    or a BlockCSR child's index bare, ``[0]``, ``.field``).  ``"name"``
    is a checkpoint's: every element bare, a BlockCSR child by its
    field."""
    kind, value = key
    if style == "name":
        return str(value)
    if kind == "attr":
        return f".{value}"
    if kind == "child":
        index = _BSR_FIELDS.index(value)
        return str(index) if style == "key" else f"[<flat index {index}>]"
    if style == "key" and kind == "dict":
        return str(value)
    return f"[{value!r}]" if kind == "dict" else f"[{value}]"


def path_str(path, style: str) -> str:
    """A leaf's path (from :func:`leaves_with_path`) joined by ``"/"``,
    each element as :func:`_key_str` prints it in ``style``."""
    return "/".join(_key_str(k, style) for k in path)


def leaves_with_path(tree, path=()):
    """``(path, leaf)`` for every leaf of ``tree`` in order: nested
    dicts, lists, tuples, NamedTuples and BlockCSRs (its four arrays, in
    the order the reference's pytree flattens them) over tensors, numpy
    arrays and Python scalars (a decode state's ``pos``, shape ``()``).
    ``None`` is an empty subtree.  A path is a tuple of ``(kind, value)``
    elements: ``("dict", key)``, ``("index", i)``, ``("attr", field)``,
    ``("child", BlockCSR field)``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (("dict", k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from leaves_with_path(getattr(tree, f),
                                         path + (("attr", f),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (("index", i),))
    elif _is_bsr(tree):
        for f in _BSR_FIELDS:
            yield from leaves_with_path(getattr(tree, f),
                                         path + (("child", f),))
    else:
        yield path, tree


def map_with_path(fn, tree, path=(), bsr=None):
    """``tree``'s structure with every leaf replaced by ``fn(path,
    leaf)``, visited in :func:`leaves_with_path`'s order.  A BlockCSR
    becomes ``bsr(node, fields, path)`` of its mapped fields (a dict by
    field name), or that dict without ``bsr``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (("dict", k),), bsr)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          path + (("attr", f),), bsr)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (("index", i),), bsr)
                          for i, v in enumerate(tree))
    if _is_bsr(tree):
        fields = {f: map_with_path(fn, getattr(tree, f),
                                   path + (("child", f),), bsr)
                  for f in _BSR_FIELDS}
        return fields if bsr is None else bsr(tree, fields, path)
    return fn(path, tree)


def tree_paths(tree, style: str = "str") -> List[Tuple[str, Tuple[int, ...]]]:
    """``(path, shape)`` of every array leaf of ``tree``, the path in the
    reference's print: ``style="str"`` as ``param_shardings`` joins
    ``str(k)``, ``"key"`` as ``state_shardings`` joins the bare keys."""
    return [(path_str(path, style), tuple(getattr(leaf, "shape", ())))
            for path, leaf in leaves_with_path(tree)]


def _shardings(tree, mesh, spec_fn, style: str):
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_fn(
            path_str(path, style), tuple(getattr(leaf, "shape", ())), mesh)),
        tree)


def param_shardings(params, mesh):
    """A :class:`NamedSharding` for every leaf of a parameter tree (or an
    optimizer state over one), in its structure; a BlockCSR's four
    arrays as a dict by field."""
    return _shardings(params, mesh, spec_for_param, "str")


def state_shardings(state, mesh):
    """A :class:`NamedSharding` for every leaf of a decode state."""
    return _shardings(state, mesh, spec_for_state, "key")


def batch_shardings(batch, mesh):
    """Input batch: the leading dim is the global batch."""
    def one(path, shape, mesh):
        dims = ("batch",) + (None,) * (len(shape) - 1)
        return logical_spec(dims, shape, mesh)
    return _shardings(batch, mesh, one, "key")


def describe_param_shardings(params, mesh) -> str:
    """Human-readable sharding table (the dry run's report)."""
    lines = []
    for path, shape in tree_paths(params, "key"):
        spec = spec_for_param(path, shape, mesh)
        lines.append(f"{path:70s} {str(shape):24s} {spec}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# placement: jax.device_put(params, param_shardings(params, mesh))
# --------------------------------------------------------------------------

# the leaves the port cuts over a mesh: the MoE experts, over ``model``
EXPERT_LEAVES = ("experts_gate", "experts_up", "experts_down")


@dataclasses.dataclass(frozen=True, eq=False)
class PeerSlices:
    """A parameter leaf of global ``shape`` cut along ``axis`` into equal
    slices, one a ``model`` peer: ``parts[pe]`` on peer ``pe``'s device
    (:func:`device_put_params`).  Indexing an int takes that layer of a
    stacked leaf from every slice, as the models index a stacked tensor
    (``axis`` must not be the layer axis)."""

    parts: Tuple[torch.Tensor, ...]
    axis: int
    shape: Tuple[int, ...]

    def __getitem__(self, i: int) -> "PeerSlices":
        if self.axis == 0:
            raise IndexError("a leaf cut along its first axis has no "
                             "layer axis to index")
        return PeerSlices(tuple(t[i] for t in self.parts), self.axis - 1,
                          tuple(self.shape[1:]))

    @property
    def requires_grad(self) -> bool:
        return any(t.requires_grad for t in self.parts)

    def map(self, fn) -> "PeerSlices":
        """The same cut with ``fn`` applied to each slice (on its
        device)."""
        return PeerSlices(tuple(fn(t) for t in self.parts), self.axis,
                          self.shape)

    def whole(self, device=None) -> torch.Tensor:
        """The slices joined on ``device`` (default: peer 0's)."""
        device = self.parts[0].device if device is None else device
        return torch.cat([t.to(device) for t in self.parts], self.axis)


def _model_axis(spec: PartitionSpec) -> Optional[int]:
    """The dimension a spec shards over ``model``, if any."""
    for i, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry):
            return i
    return None


def peer_axis(name: str, spec: PartitionSpec, mesh) -> Optional[int]:
    """The axis along which :func:`device_put_params` cuts the leaf at
    path ``name`` (``"str"`` style) of sharding ``spec``: the dimension
    ``spec`` shards over ``model`` for an MoE expert leaf
    (:data:`EXPERT_LEAVES`) on a mesh whose ``model`` axis is above 1;
    ``None`` for a leaf that stays whole."""
    if mesh.shape.get("model", 1) < 2 or not any(k in name
                                                 for k in EXPERT_LEAVES):
        return None
    return _model_axis(spec)


def device_put_params(params, mesh: Mesh):
    """``params`` placed on ``mesh``: the port's ``jax.device_put(params,
    param_shardings(params, mesh))``.

    Each MoE expert leaf (:data:`EXPERT_LEAVES`, stacked or per layer)
    whose spec (:func:`spec_for_param` under the bound rules) puts
    ``model`` on its expert axis is cut into the ``model`` peers'
    ``e_loc`` slices along that axis, and slice ``pe`` is copied to
    ``mesh.device_at(model=pe)``: a :class:`PeerSlices`, each slice a
    tensor of its own, also where the peer is the leaf's device.  Every
    other leaf goes whole to the mesh's ``(0, …, 0)`` device (no copy
    where it is there already): the port has no tensor parallelism, so
    the other axes a spec names (FSDP's ``data``, ``heads``, ``vocab``)
    place nothing.  On a mesh whose entries are all one device the placed
    tree computes the same bits as ``params``."""
    home = mesh.devices.reshape(-1)[0]
    msize = mesh.shape.get("model", 1)

    def put(path, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        name = path_str(path, "str")
        axis = peer_axis(name, spec_for_param(name, tuple(leaf.shape), mesh),
                         mesh)
        if axis is None:
            return leaf.to(home)
        e_loc = leaf.shape[axis] // msize
        parts = []
        for pe in range(msize):
            part = leaf.narrow(axis, pe * e_loc, e_loc)
            own = torch.empty(part.shape, dtype=part.dtype,
                              device=mesh.device_at(model=pe))
            parts.append(own.copy_(part))
        return PeerSlices(tuple(parts), axis, tuple(leaf.shape))
    return map_with_path(put, params, bsr=lambda node, fields, path:
                         dataclasses.replace(node, **fields))


# --------------------------------------------------------------------------
# bytes moved between mesh coordinates
# --------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_moved: Dict[str, float] = {kind: 0.0 for kind in COLLECTIVES}


def record_collective(kind: str, nbytes: float) -> None:
    """Count ``nbytes`` moved between mesh coordinates under the
    reference's collective ``kind`` (summed over every coordinate that
    receives them)."""
    _moved[kind] += float(nbytes)


def collectives_moved() -> Dict[str, float]:
    """The bytes counted so far, by kind (a copy)."""
    return dict(_moved)


class _Moved(torch.autograd.Function):
    """``x`` itself, counting its bytes under ``kind`` forward and again
    backward (the transposed collective carries the cotangent back)."""

    @staticmethod
    def forward(ctx, x, kind, copies):
        ctx.kind, ctx.copies = kind, copies
        record_collective(kind, copies * x.numel() * x.element_size())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        record_collective(ctx.kind, ctx.copies * g.numel() * g.element_size())
        return g, None, None


def moved(x: torch.Tensor, kind: str, copies: int = 1) -> torch.Tensor:
    """``x``, counted as ``copies`` times its bytes moved between
    coordinates by a collective of ``kind`` (and as many in the
    backward, where ``x`` takes a gradient)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Moved.apply(x, kind, copies)
    record_collective(kind, copies * x.numel() * x.element_size())
    return x
