"""FLOP and byte accounting by walking the aten ops a function dispatches
(port of ``repro.roofline.jaxpr_cost``).

The reference walks the jaxpr of ``fn``: static scan lengths multiply a
body's cost, so a scanned model is counted whole.  The port has no jaxpr;
:func:`jaxpr_cost` runs ``fn`` under a ``TorchDispatchMode`` and charges
every aten op it dispatches, the backward where ``fn`` runs it (on
autograd's thread too) and remat's recompute included.  On ``meta``
tensors nothing is computed: the walk is the dry run's global
(pre-partition) count, and on the card the same walk counts the same op
stream.

The reference's conventions, kept:

* dots (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, from
  ``torch.utils.flop_counter``'s registry): ``2·batch·contract·free·free``
  FLOPs, operand and result bytes;
* every other op: one FLOP an output element (transcendentals too);
* bytes only at materialization points: gathers / indexing 2× the
  output, scatters 3× the update, in-place slice updates (``copy_`` and
  the ``*_scatter`` ops) 2× the update, cheap movers (materialized
  copies, broadcast fills) 0.25× the output, reductions, sorts,
  concatenations and ``arange`` their operands and results; views are
  free, as are an allocation and a copy to another device (host metadata
  going to the card: a CPU tensor's ``.to("cpu")`` dispatches nothing);
* a fused region (:data:`FUSED_REGIONS`: ``layers.chunked_attention``'s
  forward and backward, the SSD chunk scan; the reference's
  ``FUSED_REGIONS``) counts its FLOPs in full and its bytes at its
  boundary only, its tensor operands and results;
* a hand-written kernel's call (:data:`KERNEL_CHARGES`) is charged what
  the reference's walker charges for the reference's counterpart of it,
  and the ops inside it are not: a Pallas kernel (B1 to B7, B9) its
  output elements as FLOPs and no bytes (the reference's default
  branch); B8, its dx and ``moe_dw_kernel`` the ``dot_general`` of the
  reference's ``einsum``; the SpGEMM dB the reference's scatter-add.

Both are marked by :func:`repro_torch.regions.region`; the walker sees
them whole through its ``region_call``.  The walker is a dispatch mode, so a
walk sees the calls of the thread that runs it, and of autograd's
threads for the backward that thread starts, and no other thread's.

Besides the totals, a walk records the dot FLOPs apart, the peak bytes of
live tensors it allocated (each storage counted from the op that made it
until it is freed; the arguments are not counted), the ops, and the
bytes the port's own mesh code moved between coordinates in the walk
(``distributed.sharding.record_collective``).
"""

from __future__ import annotations

import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import collectives_moved

aten = torch.ops.aten


class Cost:
    """Global FLOPs and bytes of a walk (the reference's ``Cost``), with
    the dot FLOPs, the peak live bytes, the op count and the collective
    bytes beside them."""

    __slots__ = ("flops", "bytes", "dot_flops", "peak_bytes", "ops",
                 "collectives")

    def __init__(self, flops=0.0, nbytes=0.0):
        self.flops = flops
        self.bytes = nbytes
        self.dot_flops = 0.0
        self.peak_bytes = 0.0
        self.ops = 0
        self.collectives: Dict[str, float] = {}

    def __iadd__(self, other):
        self.flops += other.flops
        self.bytes += other.bytes
        return self

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)


def _packets(*names):
    return frozenset(getattr(aten, n) for n in names if hasattr(aten, n))


_FREE = _packets(
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "detach", "alias", "lift_fresh", "scalar_tensor",
    "_local_scalar_dense", "set_", "resize_", "_reshape_alias",
    "is_same_size", "_has_compatible_shallow_copy_type")
_CHEAP_MOVERS = _packets(
    "clone", "repeat", "expand_copy", "permute_copy", "zeros", "ones",
    "full", "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full", "tril", "triu", "roll")
_GATHER = _packets(
    "index", "index_select", "gather", "embedding", "take",
    "take_along_dim", "_unsafe_index")
_SLICE_UPDATE = _packets(
    "copy_", "slice_scatter", "select_scatter", "as_strided_scatter",
    "diagonal_scatter", "_copy_from", "_copy_from_and_resize")
_SCATTER = _packets(
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "index_add", "index_add_", "index_copy",
    "index_copy_", "scatter_reduce", "scatter_reduce_",
    "embedding_dense_backward", "_unsafe_index_put", "index_fill_",
    "masked_scatter_", "masked_scatter")
_MATERIALIZING = _packets(
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "any", "all", "sort", "argsort", "topk", "cat", "stack",
    "constant_pad_nd", "flip", "arange", "logsumexp", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "searchsorted", "bincount", "norm", "linalg_vector_norm", "var_mean",
    "std_mean", "var", "std", "nonzero", "unique", "_unique2",
    "randperm", "rand", "randn", "randint", "normal_", "uniform_",
    "bernoulli_", "multinomial", "native_layer_norm",
    "native_layer_norm_backward")
_DOTS = frozenset(flop_registry)


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor in nested lists, tuples and dicts (no recursive
    closure: its reference cycle would keep the tensors alive until a
    garbage collection and blur the peak of live bytes)."""
    out, stack = [], [tree]
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            stack.extend(reversed(a))
        elif isinstance(a, dict):
            stack.extend(reversed(list(a.values())))
    return out


def _op_tensors(args, kwargs) -> List[torch.Tensor]:
    """An op's tensor operands (aten ops nest them one list deep)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(v for v in a if isinstance(v, torch.Tensor))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _numel(ts) -> int:
    return sum(t.numel() for t in ts)


# an op's walk category, by its overload packet
_CATEGORIES = [(_FREE, "free"), (_DOTS, "dot"), (_CHEAP_MOVERS, "mover"),
               (_GATHER, "gather"), (_SLICE_UPDATE, "update"),
               (_SCATTER, "scatter"), (_MATERIALIZING, "materialize")]
_INFO: Dict = {}
_META_OF: Dict = {}       # a meta op's result layout, by its arguments'


def _info(func):
    """``(is_view, is_mutable, category)`` of an op, looked up once."""
    info = _INFO.get(func)
    if info is None:
        packet = func.overloadpacket
        category = next((name for members, name in _CATEGORIES
                         if packet in members),
                        "pointwise" if torch.Tag.pointwise in func.tags
                        else "default")
        info = (func.is_view, func._schema.is_mutable, category)
        _INFO[func] = info
    return info


def _meta_key(a):
    if isinstance(a, torch.Tensor):
        return ("tensor", a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_meta_key(v) for v in a)
    return a


def _described(out):
    """An op's result as (shape, strides, dtype) triples, or None where
    it is not a tensor or a tuple of them."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype)
    if isinstance(out, tuple) and out and all(isinstance(t, torch.Tensor)
                                              for t in out):
        return tuple((t.shape, t.stride(), t.dtype) for t in out)
    return None


def _meta_result(func, args, kwargs):
    """A functional op's result on ``meta`` operands: the meta kernel's
    once (many are Python, the slow part of a ``meta`` walk), then, for
    the same op on operands of the same shapes, strides and dtypes and
    the same other arguments, new tensors of the shapes, strides and
    dtypes it gave (what a layout-sensitive view of them does follows).
    An op whose result shares an operand's storage (``_unsafe_view``)
    always runs: a new tensor would be a new allocation."""
    key = (func, _meta_key(args),
           tuple(sorted((k, _meta_key(v)) for k, v in kwargs.items())))
    try:
        hit = _META_OF.get(key)
    except TypeError:               # an unhashable argument
        return func(*args, **kwargs)
    if hit is None or hit is _ALIASES:
        out = func(*args, **kwargs)
        desc = _described(out)
        if hit is None and desc is not None:
            _META_OF[key] = _ALIASES if _storages(_tensors(out)) & \
                _storages(_op_tensors(args, kwargs)) else desc
        return out
    if isinstance(hit[0], torch.Size):
        return torch.empty_strided(hit[0], hit[1], dtype=hit[2],
                                   device="meta")
    return tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                 for sh, st, dt in hit)


_ALIASES = object()         # a memo entry: the result is an operand's


def _storages(ts) -> set:
    return {t.untyped_storage()._cdata for t in ts}


class _Walker(TorchDispatchMode):
    """Charges every aten op it sees to ``cost``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.kernel_depth = 0       # inside a kernel's call: no charge
        self.fused_depth = 0        # inside a fused region: no bytes
        self.live = 0.0
        self.seen = set()

    # ---- live bytes ----------------------------------------------------
    def _free(self, key, nbytes):
        self.seen.discard(key)
        self.live -= nbytes

    def _track(self, outs, ts) -> None:
        """Count the storages of ``outs`` not seen before and not the
        operands' ``ts`` (an argument of the walked function is not a
        temporary)."""
        operands = _storages(ts)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen or key in operands:
                continue
            nbytes = st.nbytes()
            self.seen.add(key)
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes)
        if self.live > self.cost.peak_bytes:
            self.cost.peak_bytes = self.live

    # ---- running an op -------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        is_view, mutable, category = _info(func)
        ts = _op_tensors(args, kwargs)
        if not (is_view or mutable) and ts and all(t.is_meta for t in ts):
            out = _meta_result(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        if is_view:
            return out
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
        if not mutable:
            self._track(outs, ts)
        if self.kernel_depth or category == "free" or (
                func.overloadpacket is aten._to_copy
                and ts and ts[0].device != outs[0].device):
            return out                  # a move between devices is free
        self.cost.ops += 1
        self._charge(func, category, args, kwargs, ts, out, outs)
        return out

    def _charge(self, func, category, args, kwargs, ts, out, outs) -> None:
        c = self.cost
        b = 0.0 if self.fused_depth else 1.0
        if category == "pointwise" or category == "default":
            c.flops += _numel(outs)     # the reference's default too
        elif category == "dot":
            flops = flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out)
            c.flops += flops
            c.dot_flops += flops
            c.bytes += b * (_nbytes(ts) + _nbytes(outs))
        elif category == "mover":
            c.bytes += b * 0.25 * _nbytes(outs)
        elif category == "gather":
            c.flops += _numel(outs)
            c.bytes += b * 2.0 * _nbytes(outs)
        elif category == "update":
            c.bytes += b * 2.0 * _nbytes(_tensors(args[1:2]))
        elif category == "scatter":
            upd = _tensors((args[-1:], kwargs.get("src"),
                            kwargs.get("values"), kwargs.get("source")))
            c.flops += _numel(upd)
            c.bytes += b * 3.0 * _nbytes(upd)
        else:                           # materializing
            c.flops += _numel(outs)
            c.bytes += b * (_nbytes(ts) + _nbytes(outs))

    # ---- a region (repro_torch.regions) --------------------------------
    def region_call(self, fn, args, kwargs):
        """A kernel's call is charged :data:`KERNEL_CHARGES`' cost and
        none of the ops inside it; a fused region's ops are charged with
        no bytes, and its boundary's bytes after.  A region inside a
        kernel's call is that call's; a region of neither kind raises."""
        if self.kernel_depth:
            return fn(*args, **kwargs)
        if fn.__name__ in FUSED_REGIONS:
            self.fused_depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.fused_depth -= 1
            if not self.fused_depth:
                self.cost.bytes += (_nbytes(_tensors((args, kwargs)))
                                    + _nbytes(_tensors(out)))
            return out
        name = f"{fn.__module__.rpartition('.')[2]}.{fn.__name__}"
        if name not in KERNEL_CHARGES:
            raise KeyError(f"the walk has no charge for the region {name}")
        flops, nbytes, dot = KERNEL_CHARGES[name](*args, **kwargs)
        c = self.cost
        c.ops += 1
        c.flops += flops
        c.bytes += nbytes
        if dot:
            c.dot_flops += flops
        self.kernel_depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self.kernel_depth -= 1


# ---- what a region is charged ---------------------------------------------

def pallas_charge(out_shape):
    """What the reference's walker charges a ``pallas_call`` (its default
    branch): one FLOP an element of the output of ``out_shape``, no
    bytes."""
    n = 1
    for d in out_shape:
        n *= int(d)
    return float(n), 0.0, False


def _einsum_charge(a, b, out_cols: int):
    """What the reference's walker charges its ``einsum`` over the MoE
    capacity buffers (``models/moe.py:97``), a ``dot_general``: 2·T·K·N
    FLOPs, its operands' and result's bytes (``a`` (T, K), ``b`` the
    (E, K, N) weights or the (T, N) cotangent)."""
    t, k = a.shape
    flops = 2.0 * t * k * out_cols
    return flops, a.element_size() * (a.numel() + b.numel()
                                      + t * out_cols), True


def _moe_dw_charge(x, dy, expert_of_tile, n_experts, *, bt):
    flops, nbytes, dot = _einsum_charge(x, dy, dy.shape[1])
    # the result is the (E, D, F) gradient, not a (T, F) one
    nbytes += x.element_size() * (n_experts * x.shape[1] * dy.shape[1]
                                  - x.shape[0] * dy.shape[1])
    return flops, nbytes, dot


def _spgemm_db_charge(dc, a_value, plan, *, n_slots):
    """The reference's SpGEMM dB: a scatter-add of the ``(m·la, lb)`` f32
    contributions (``ops.py:934-957``), one FLOP an update, 3× its
    bytes."""
    updates = plan.shape_a[0] * plan.la * plan.lb
    return float(updates), 12.0 * updates, False


# A hand-written kernel's wrapper (``module.function`` in
# ``repro_torch.kernels``) and what the reference's walker charges for the
# reference's counterpart of the call, a ``(flops, bytes, dot)`` triple
# from the wrapper's arguments: a Pallas kernel (B1 to B7, B9) its
# default branch; B8, its dx and ``moe_dw_kernel`` the ``dot_general`` of
# the reference's einsum; the SpGEMM dB the reference's scatter-add.
KERNEL_CHARGES = {
    "maple_spmm.maple_spmm_naive":
        lambda blocks, row_ptr, block_col, b3, **kw: pallas_charge(
            (b3.shape[0], (row_ptr.numel() - 1) * blocks.shape[1],
             b3.shape[2])),
    "maple_spmm.maple_spmm_compact":
        lambda blocks, order, step_col, runs, b3, *, n_slots, **kw:
        pallas_charge((b3.shape[0], n_slots * blocks.shape[1],
                       b3.shape[2])),
    "maple_spmm.maple_spmm_planned":
        lambda blocks, order, step_col, row_runs, row_run_ptr, b3, **kw:
        pallas_charge((b3.shape[0],
                       (row_run_ptr.numel() - 1) * blocks.shape[1],
                       b3.shape[2])),
    "maple_sddmm.maple_sddmm_bsr":
        lambda dc, b3, block_row, block_col, *, bm, bk, **kw:
        pallas_charge((block_col.shape[0], bm, bk)),
    "maple_spgemm.maple_spgemm_numeric":
        lambda a_value, b_value, plan, *, cap: pallas_charge((cap,)),
    "maple_spgemm.maple_sddmm_csr":
        lambda dc, b_value, plan, *, n_slots: pallas_charge((n_slots,)),
    "maple_spgemm.maple_spgemm_db": _spgemm_db_charge,
    "maple_spmspm.maple_spmspm_ell":
        lambda values, col_ids, b: pallas_charge((values.shape[0],
                                                  b.shape[1])),
    "block_attn.block_attention":
        lambda q, *a, **kw: pallas_charge(q.shape),
    "moe_gemm._forward":
        lambda x, expert_of_tile, w, bt: _einsum_charge(x, w, w.shape[2]),
    "moe_gemm.moe_gemm_dx":
        lambda dy, expert_of_tile, w, *, bt: _einsum_charge(dy, w,
                                                            w.shape[1]),
    "moe_gemm.moe_gemm_dw": _moe_dw_charge,
}

# The functions whose interior a fused kernel keeps on chip (the
# reference's named jit regions: flash attention forward and backward, the
# SSD chunk scan): their FLOPs count in full, their bytes at the boundary,
# their tensor arguments and results.
FUSED_REGIONS = ("_flash_forward_impl", "_flash_backward_impl", "ssd_scan")


def jaxpr_cost(fn, *args, **kwargs) -> Cost:
    """Global (pre-partition) FLOPs and bytes of ``fn(*args, **kwargs)``,
    walked on whatever device its arguments are on (``meta`` for the dry
    run)."""
    w = _Walker()
    moved0 = collectives_moved()
    with w:
        fn(*args, **kwargs)
    moved1 = collectives_moved()
    w.cost.collectives = {k: moved1[k] - moved0[k] for k in moved1
                          if moved1[k] != moved0[k]}
    return w.cost
