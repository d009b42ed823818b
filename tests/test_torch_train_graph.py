"""The compiled train step on the CPU: what a CUDA graph of the whole
step needs of the optimizer, and the callable that stands for the
reference's ``jax.jit(make_train_step(...))``.

* ``apply_updates`` returns the state it was given: the step count, both
  moments and every error-feedback residual keep their storage over
  steps (a replay writes to the addresses it was captured with), and
  the values stay within 1e-6 of the reference's ``apply_updates`` on the
  same numpy inputs (f32, one leaf at a time, as ``test_torch_train``).
* ``jitted_train_step`` on the CPU is the eager step, bit for bit over 3
  steps (qwen3-4b's smoke config with the sparse MLP; granite's at 2
  microbatches).
* ``launch/train.py --smoke --device cpu`` from the reference's initial
  parameters: each step's loss within 1e-5 relative of the reference
  launcher's jitted step on the same data (``test_torch_train``'s
  tolerance for the loss).
* ``StepGraph(grad=True)`` keys, captures, replays and releases as the
  serving one, with autograd on, on a side stream of its own, checked
  with a stand-in for ``torch.cuda`` (this machine has none).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.csr import BlockCSR as RefBlockCSR
from repro.data import DataConfig as RefDataConfig
from repro.data import synth_batch as ref_synth_batch
from repro.models import lm as ref_lm
from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train import apply_updates as ref_apply_updates
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.csr import BlockCSR
from repro_torch.data import DataConfig, synth_batch
from repro_torch.kernels import launch_counters, maple_spmm_naive
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.serve import graphs
from repro_torch.serve.graphs import StepGraph
from repro_torch.train import (OptimizerConfig, apply_updates,
                               init_opt_state, jitted_train_step,
                               make_train_step)
from repro_torch.train.optimizer import named_leaves
from test_torch_train import flatten_ref, port_leaves, ref_leaves


# --------------------------------------------------------------------------
# the optimizer keeps its state's storage
# --------------------------------------------------------------------------

def _storage(state):
    return ([state.step.data_ptr()]
            + [t.data_ptr() for d in (state.m, state.v, state.error)
               for t in d.values()])


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_keeps_the_state_storage(compress):
    rng = np.random.default_rng(21)
    arr = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    meta = dict(block_col=np.array([0, 1, -1], np.int32),
                block_row=np.array([0, 1, 1], np.int32),
                row_ptr=np.array([0, 1, 2], np.int32))
    p_np = {"w": arr(6, 5), "b_bias": arr(3), "w_down": arr(3, 4, 4)}
    ref_p = {"w": jnp.asarray(p_np["w"]),
             "b_bias": jnp.asarray(p_np["b_bias"]),
             "w_down": RefBlockCSR(jnp.asarray(p_np["w_down"]),
                                   *(jnp.asarray(meta[k]) for k in
                                     ("block_col", "block_row", "row_ptr")),
                                   (8, 8), (4, 4))}
    port_p = {"w": torch.tensor(p_np["w"]),
              "b_bias": torch.tensor(p_np["b_bias"]),
              "w_down": BlockCSR(torch.tensor(p_np["w_down"]), shape=(8, 8),
                                 block_shape=(4, 4), **meta)}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
              compress_grads=compress)
    ref_cfg, cfg = RefOptimizerConfig(**kw), OptimizerConfig(**kw)
    ref_state, state = (ref_init_opt_state(ref_cfg, ref_p),
                        init_opt_state(cfg, port_p))
    storage, leaves = _storage(state), [t.data_ptr() for _, t in
                                        named_leaves(port_p)]
    for _ in range(3):
        g_np = {k: arr(*v.shape) * 30.0 for k, v in p_np.items()}
        ref_g = {"w": jnp.asarray(g_np["w"]),
                 "b_bias": jnp.asarray(g_np["b_bias"]),
                 "w_down": RefBlockCSR(jnp.asarray(g_np["w_down"]),
                                       *(jnp.zeros(3, jnp.int32),) * 3,
                                       (8, 8), (4, 4))}
        grads = {"w": torch.tensor(g_np["w"]),
                 "b_bias": torch.tensor(g_np["b_bias"]),
                 "w_down": dataclasses.replace(
                     port_p["w_down"], blocks=torch.tensor(g_np["w_down"]))}
        ref_p, ref_state, ref_m = ref_apply_updates(ref_cfg, ref_p, ref_g,
                                                    ref_state)
        given = state
        port_p, state, m = apply_updates(cfg, port_p, grads, state)
        assert state is given
        assert _storage(state) == storage
        assert [t.data_ptr() for _, t in named_leaves(port_p)] == leaves
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)
        want = dict(ref_leaves(ref_p))
        for path, got in port_leaves(port_p).items():
            np.testing.assert_allclose(got, want[path], rtol=1e-6,
                                       atol=1e-6, err_msg=path)
        assert int(state.step) == int(ref_state.step)
    assert int(state.step) == 3


# --------------------------------------------------------------------------
# the compiled step on the CPU is the eager step
# --------------------------------------------------------------------------

def _params(cfg, seed):
    return lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))


@pytest.mark.parametrize("arch,over,n_micro", [
    ("qwen3-4b", dict(sparse_mlp=True, sparse_block=(8, 8)), 1),
    ("granite-moe-3b-a800m", {}, 2)])
def test_jitted_step_on_the_cpu_is_the_eager_step(arch, over, n_micro):
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=2, total_steps=10)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    runs = []
    for jit in (True, False):
        params = _params(cfg, 3)
        step = make_train_step(cfg, ocfg, n_micro,
                               mlp_plan=lm.sparse_mlp_plan(params))
        fn = jitted_train_step(step, "cpu") if jit else step
        assert fn is step
        opt, metrics = init_opt_state(ocfg, params), []
        for i in range(3):
            params, opt, m = fn(params, opt, synth_batch(dcfg, i))
            metrics.append(m)
        runs.append((params, opt, metrics))
    (pa, oa, ma), (pb, ob, mb) = runs
    for a, b in zip(ma, mb):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (ka, a), (kb, b) in zip(named_leaves(pa), named_leaves(pb)):
        assert ka == kb and torch.equal(a, b), ka
    for name in ("m", "v"):
        for k, t in getattr(oa, name).items():
            assert torch.equal(t, getattr(ob, name)[k]), (name, k)
    assert int(oa.step) == int(ob.step) == 3


def test_launcher_losses_follow_the_reference_launcher(monkeypatch):
    """``launch/train.py --arch qwen3-4b --smoke --device cpu --steps 3``
    against the reference launcher's loop (``jax.jit(make_train_step)``
    over ``synth_batch``, the same defaults), both from the reference's
    initial parameters."""
    steps, seed = 3, 0
    cfg_ref = ref_smoke_config("qwen3-4b")
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(seed))
    stacked = params_from_numpy(flatten_ref(params_ref),
                                get_smoke_config("qwen3-4b"), device="cpu")
    monkeypatch.setattr(lm, "init_params",
                        lambda cfg, gen, device=None: stacked)
    run = launch_train.main(["--arch", "qwen3-4b", "--smoke", "--device",
                             "cpu", "--steps", str(steps),
                             "--seed", str(seed)])
    assert run.step_fn.__name__ == "train_step"          # eager on the CPU

    ocfg = RefOptimizerConfig(peak_lr=3e-3, warmup_steps=5,
                              total_steps=max(steps, 10))
    dcfg = RefDataConfig(vocab_size=cfg_ref.vocab_size, seq_len=64,
                         global_batch=4, seed=seed)
    step_fn = jax.jit(ref_make_train_step(
        cfg_ref, ocfg, None, mlp_plan=ref_lm.sparse_mlp_plan(params_ref)))
    params, opt = params_ref, ref_init_opt_state(ocfg, params_ref)
    for i in range(steps):
        params, opt, m = step_fn(params, opt, ref_synth_batch(dcfg, i, {}))
        np.testing.assert_allclose(run.history[i]["loss"], float(m["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")


# --------------------------------------------------------------------------
# StepGraph's training mode, with a stand-in for torch.cuda
# --------------------------------------------------------------------------

class _Stream:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def wait_stream(self, other):
        self.log.append(("wait", self.name, other.name))


class _Graph:
    """Stands for ``torch.cuda.CUDAGraph``: the step runs once, inside the
    capture (a real capture runs nothing, and the replay after it runs
    the step); ``replay`` runs nothing."""

    def __init__(self, keep_graph=False):
        self.replays = 0

    def instantiate(self):
        pass

    def pool(self):
        return (0, 0)

    def replay(self):
        self.replays += 1


class _FakeCuda:
    """The calls ``StepGraph`` makes of ``torch.cuda``, logged."""

    def __init__(self, monkeypatch):
        self.log = []
        self.current = _Stream(self.log, "current")
        self.side = []
        cuda = torch.cuda

        def new_stream(device=None):
            self.side.append(_Stream(self.log, f"side{len(self.side)}"))
            return self.side[-1]

        @contextlib.contextmanager
        def on_stream(stream):
            self.log.append(("stream", stream.name))
            yield

        @contextlib.contextmanager
        def capture(graph, stream=None, **kw):
            self.log.append(("capture", getattr(stream, "name", None),
                             torch.is_grad_enabled()))
            yield

        for name, fn in (("synchronize", lambda device=None: None),
                         ("empty_cache",
                          lambda: self.log.append(("empty_cache",))),
                         ("Stream", new_stream), ("stream", on_stream),
                         ("current_stream", lambda device=None: self.current),
                         ("CUDAGraph", _Graph), ("graph", capture)):
            monkeypatch.setattr(cuda, name, fn)
        monkeypatch.setattr(graphs, "_graph_nodes", lambda g: 7)
        monkeypatch.setattr(graphs, "_pool_bytes", lambda pool, dev: 512)


def _step(calls, w):
    """A step that records each time it runs and whether autograd was on;
    it updates ``w`` in place and returns a fresh metric."""
    def fn(feeds):
        calls.append(torch.is_grad_enabled())
        loss = (w * feeds["x"]).sum()
        with torch.no_grad():
            w.add_(feeds["x"])
        maple_spmm_naive.launches += 2        # as a kernel wrapper counts
        return {"loss": loss.detach()}
    return fn


@pytest.mark.parametrize("grad", [False, True])
def test_training_capture_keys_and_releases_like_serving(monkeypatch, grad):
    fake = _FakeCuda(monkeypatch)
    graph = StepGraph("a step", grad=grad)
    w, other = torch.zeros(3), torch.zeros(3)
    calls = []
    x = torch.arange(3.0)
    before = maple_spmm_naive.launches

    def call(held):
        return graph(_step(calls, held), {"x": x}, (held,), "cpu")

    call(w)                                   # the warm-up: eager
    assert calls == [grad] and not graph.captured
    assert maple_spmm_naive.launches - before == 2
    call(w)                                   # the capture, then a replay
    assert graph.captured and (graph.captures, graph.replays) == (1, 1)
    assert calls == [grad, grad]
    assert (graph.nodes, graph.pool_bytes) == (7, 512)
    assert maple_spmm_naive.launches - before == 4
    out = call(w)                             # a replay alone
    assert len(calls) == 2 and graph.replays == 2
    assert maple_spmm_naive.launches - before == 6
    assert torch.is_tensor(out["loss"])
    # the cached blocks go back before the capture; a training step warms
    # up and captures on its own stream, a serving step on torch's
    side = "side0" if grad else None
    i = fake.log.index(("capture", side, grad))
    assert ("empty_cache",) in fake.log[:i]
    if grad:
        assert fake.log[:4] == [("empty_cache",),
                                ("wait", "side0", "current"),
                                ("stream", "side0"),
                                ("wait", "current", "side0")]
    else:
        assert not fake.side and ("stream", "side0") not in fake.log
    # other held tensors: the graph is dropped, a warm-up, then a capture
    call(other)
    assert not graph.captured and len(calls) == 3
    call(other)
    assert graph.captured and graph.captures == 2 and len(calls) == 4
    # released: the next call warms up again
    graph.release()
    call(other)
    assert not graph.captured and len(calls) == 5
    assert len(fake.side) == (1 if grad else 0)


def test_a_failed_training_capture_raises_and_never_runs_eagerly(
        monkeypatch):
    _FakeCuda(monkeypatch)
    graph = StepGraph("the train step of a test", grad=True)
    w = torch.zeros(3)
    calls = []
    step = _step(calls, w)

    def fn(feeds):                   # every run after the warm-up fails
        if calls:
            raise RuntimeError("a host read")
        return step(feeds)

    graph(fn, {"x": torch.ones(3)}, (w,), "cpu")
    counts = {k: f.launches for k, f in launch_counters().items()}
    for _ in range(2):                # no eager fall-back on a later call
        with pytest.raises(RuntimeError,
                           match="capturing the train step of a test as a "
                                 "CUDA graph failed: RuntimeError: a host "
                                 "read"):
            graph(fn, {"x": torch.ones(3)}, (w,), "cpu")
        assert not graph.captured
    assert len(calls) == 1
    assert counts == {k: f.launches for k, f in launch_counters().items()}
