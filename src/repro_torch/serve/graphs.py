"""Steps captured once as CUDA graphs and replayed: the port's
counterpart of the reference's ``jax.jit``-compiled serving and training
steps.

A :class:`StepGraph` runs a step function ``fn(feeds)`` on the card.
``feeds`` are the step's small per-call inputs (tokens, positions, a
block table; a training batch): ints or tensors on any device.
Everything else the step reads or writes (parameters, caches, a logit
head; the optimizer state) it closes over; the caller names those
objects in ``held``.

* The first call on a set of held objects runs the step eagerly: the
  warm-up, where kernels are built and lazily made device arrays (a
  plan's index tensors, B4's arrival counters) are allocated.
* The next call on the same objects captures the step into a
  ``torch.cuda.CUDAGraph`` (into static feed buffers allocated for it),
  then replays it; every later call copies its feeds into those buffers
  and replays.  The cached blocks of the warm-up are given back to the
  card before the capture, so that they and the graph's private pool are
  not held side by side.
* A serving step warms up and is captured under ``torch.no_grad()``.  A
  training step (``grad=True``) runs both with autograd on, as torch's
  whole-network recipe does: on a side stream of its own, so that the
  backward, which autograd runs on the stream of its forward, and every
  per-stream workspace a library makes on its first use, are the
  capture's from the warm-up on.  Its gradients and accumulators are
  allocated inside the capture, in the graph's pool.
* A graph replays raw addresses, so it holds references to every held
  object and to the bound mesh it was captured under, and is dropped
  (recaptured after a new warm-up) when it is handed other objects,
  other feed shapes, or another mesh is bound.  It never replays onto
  memory it does not hold.
* Outputs come back as fresh tensors (clones of the graph's outputs).
  A step that updates held tensors in place returns only what is new.
* The kernel wrappers count launches in Python, so a capture counts and
  a replay does not: the capture's increments are undone, and their
  delta is added on every replay (``kernels.launch_counters``).
* A capture that fails raises, saying why; nothing falls back to the
  eager step.
"""

from __future__ import annotations

import ctypes
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import active_mesh
from repro_torch.kernels import launch_counters


def captured(device: torch.device) -> bool:
    """Whether a serving or training step on ``device`` runs as a
    captured CUDA graph: on a card, unless the bound mesh's entries name
    several cards.  A capture records one card's stream into a pool of
    that card; peers' launches and allocations on other cards would join
    it only through the copies' events, outside that pool, so across
    cards the eager step runs (capture across cards: ROADMAP's work held
    for after the first benchmark, item 10.2)."""
    mesh = active_mesh()
    return device.type == "cuda" and (mesh is None
                                      or not sharding.several(mesh))


def _walk(tree, leaves: list) -> None:
    """Tensors and other objects of a tree of dicts, lists and tuples,
    in order (ints, floats, strings and None are values, not memory)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _walk(v, leaves)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _walk(v, leaves)
    elif tree is not None and not isinstance(tree, (bool, int, float, str)):
        leaves.append(tree)


def _identity(obj):
    """What a replay depends on: a tensor's memory and layout, any other
    object's identity."""
    if torch.is_tensor(obj):
        return (obj.data_ptr(), tuple(obj.shape), obj.stride(), obj.dtype,
                obj.device)
    return id(obj)


def _feed_spec(v):
    if torch.is_tensor(v):
        return tuple(v.shape), v.dtype
    return type(v)


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if torch.is_tensor(tree) else tree


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> Optional[int]:
    """The node count of a captured (not yet instantiated) graph, from
    libcuda's ``cuGraphGetNodes``; None if the call fails."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


def _pool_bytes(pool, device) -> int:
    """Bytes of the segments the caching allocator holds for ``pool``."""
    dev = torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if s["device"] == dev
               and tuple(s["segment_pool_id"]) == tuple(pool))


class StepGraph:
    """One step captured as a CUDA graph (see the module's docstring);
    ``grad=True`` for a training step.  ``captures`` and ``replays``
    count what it did; ``capture_ms`` (the capture and the graph's
    instantiation), ``nodes`` and ``pool_bytes`` (the graph's private
    memory pool) describe the last capture."""

    def __init__(self, name: str, *, grad: bool = False):
        self.name = name
        self.grad = grad
        self._stream = None
        self.captures = 0
        self.replays = 0
        self.capture_ms: Optional[float] = None
        self.nodes: Optional[int] = None
        self.pool_bytes: Optional[int] = None
        self._warm = None
        self._drop()

    def _drop(self) -> None:
        self._graph = None
        self._key = None
        self._held = None
        self._buffers: Dict[str, torch.Tensor] = {}
        self._outs = None
        self._delta: Dict[str, int] = {}

    def release(self) -> None:
        """Drop the graph, its pool and the references it holds; the next
        call warms up again."""
        self._drop()
        self._warm = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, fn: Callable[[Dict[str, Any]], Any],
                 feeds: Dict[str, Any], held, device) -> Any:
        mesh = active_mesh()
        leaves: list = []
        _walk((held, mesh), leaves)
        key = (str(device), tuple(_identity(o) for o in leaves),
               tuple((k, _feed_spec(v)) for k, v in feeds.items()))
        if self._graph is not None and key == self._key:
            return self._replay(feeds)
        self._drop()
        if key != self._warm:
            self._warm = key
            return self._warm_up(fn, {k: self._to_device(v, device)
                                      for k, v in feeds.items()}, device)
        self._capture(fn, feeds, device)
        self._key, self._held = key, leaves
        return self._replay(feeds)

    @staticmethod
    def _to_device(v, device) -> torch.Tensor:
        if torch.is_tensor(v):
            return v.to(device)
        return torch.full((), v, dtype=torch.long, device=device)

    def _autograd(self):
        return torch.enable_grad() if self.grad else torch.no_grad()

    def _side_stream(self, device):
        """A training step's own stream (None for a serving step: it
        warms up on the current stream and is captured on torch's)."""
        if self.grad and self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _warm_up(self, fn, feeds, device) -> Any:
        side = self._side_stream(device)
        if side is None:
            with self._autograd():
                return fn(feeds)
        # the caching allocator keeps freed blocks per stream: give the
        # current stream's back, or they and the side stream's stay
        # reserved side by side
        torch.cuda.empty_cache()
        side.wait_stream(torch.cuda.current_stream(device))
        with self._autograd(), torch.cuda.stream(side):
            out = fn(feeds)
        torch.cuda.current_stream(device).wait_stream(side)
        return out

    def _capture(self, fn, feeds, device) -> None:
        counters = launch_counters()
        before = {k: f.launches for k, f in counters.items()}
        self._buffers = {k: self._to_device(v, device).clone()
                         for k, v in feeds.items()}
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        # kept uninstantiated until its nodes are counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        first = []                        # the step's own error, if any
        try:
            with self._autograd(), torch.cuda.graph(
                    graph, stream=self._side_stream(device)):
                try:
                    outs = fn(dict(self._buffers))
                except Exception as err:
                    first.append(err)
                    raise
        except Exception as err:
            # ending a failed capture raises an error of its own: report
            # the step's, which says why
            err = first[0] if first else err
            for k, f in counters.items():
                f.launches = before[k]
            self._drop()
            raise RuntimeError(
                f"capturing {self.name} as a CUDA graph failed: "
                f"{type(err).__name__}: {err}") from err
        for k, f in counters.items():
            self._delta[k] = f.launches - before[k]
            f.launches = before[k]
        self.nodes = _graph_nodes(graph)
        graph.instantiate()
        torch.cuda.synchronize(device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = _pool_bytes(graph.pool(), device)
        self.captures += 1
        self._graph, self._outs = graph, outs

    def _replay(self, feeds) -> Any:
        for k, v in feeds.items():
            buf = self._buffers[k]
            if torch.is_tensor(v):
                buf.copy_(v, non_blocking=True)
            else:
                buf.fill_(v)
        self._graph.replay()
        self.replays += 1
        counters = launch_counters()
        for k, n in self._delta.items():
            if n:
                counters[k].launches += n
        return _tree_map(torch.clone, self._outs)
