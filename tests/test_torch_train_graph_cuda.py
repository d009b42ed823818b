"""The compiled train step on the card (``train.jitted_train_step``): the
whole step (forward with remat, the hand-written backward, microbatch
accumulation, the global-norm clip, AdamW) captured once as a CUDA graph
and replayed, against the eager ``make_train_step`` on a second copy of
the same parameters: losses, grad norms, learning rates, every parameter
and both moments bit for bit, and every kernel's launches exactly the
eager run's; a replayed step and an eager step after the warm-up make no
host sync; a checkpoint's tensors are warmed up and captured afresh; a
step that reads the card on the host cannot be captured and never runs
eagerly instead.

These tests need an NVIDIA GPU and the CUDA toolkit (``nvcc``); without a
card they skip.  They import nothing of JAX:

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_train_graph_cuda.py
"""

import dataclasses
import os
import traceback
import warnings

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, synth_batch
from repro_torch.distributed.sharding import use_mesh
from repro_torch.ft import checkpoint as ckpt
from repro_torch.kernels import launch_counters
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               jitted_train_step, make_train_step)
from repro_torch.train.optimizer import named_leaves

pytestmark = pytest.mark.cuda

STEPS = 4
SPARSE = dict(sparse_mlp=True, sparse_block=(8, 8))
# case id: (arch, config overrides, microbatches, sequence length, mesh)
CASES = {"qwen3": ("qwen3-4b", SPARSE, 1, 16, None),
         "qwen3_micro2": ("qwen3-4b", SPARSE, 2, 16, None),
         "granite": ("granite-moe-3b-a800m", {}, 2, 16, None),
         "granite_ep": ("granite-moe-3b-a800m", dict(moe_impl="ep_a2a"), 2,
                        16, (1, 4)),
         "whisper": ("whisper-base", {}, 2, 16, None),
         "internvl_sparse": ("internvl2-1b", SPARSE, 2, 16, None),
         "mamba2": ("mamba2-2.7b", {}, 2, 64, None),
         "hybrid_sparse": ("recurrentgemma-9b", SPARSE, 2, 48, None),
         "qwen3_moe": ("qwen3-moe-235b-a22b", {}, 2, 16, None)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    yield torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _setup(cuda, case):
    arch, over, n_micro, seq, mesh = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=2, total_steps=10)
    extra = {}
    if cfg.n_enc_layers:
        extra["enc_frames"] = (4, cfg.enc_seq, cfg.d_model)
    if cfg.n_patches:
        extra["vision_embeds"] = (4, cfg.n_patches, cfg.d_model)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=4, seed=1)
    batches = [{k: v.to(cuda) for k, v in synth_batch(dcfg, i,
                                                      extra).items()}
               for i in range(STEPS)]
    bound = make_debug_mesh(mesh, device="cuda") if mesh else None
    return cfg, ocfg, n_micro, batches, bound


def _model(cfg, cuda, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return lm.unstack_layers(lm.init_params(cfg, gen, device=cuda))


def _counts():
    return {k: f.launches for k, f in launch_counters().items()}


def _run(step, params, opt, batches, mesh):
    """Each batch through ``step``: (params, opt, metrics a step, launches
    a kernel)."""
    before, metrics = _counts(), []
    with use_mesh(mesh):
        for batch in batches:
            params, opt, m = step(params, opt, batch)
            metrics.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    after = _counts()
    return params, opt, metrics, {k: after[k] - before[k] for k in after}


def _assert_equal_runs(got, want):
    (pa, oa, ma, la), (pb, ob, mb, lb) = got, want
    for i, (a, b) in enumerate(zip(ma, mb)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k, a[k], b[k])
    for (ka, a), (kb, b) in zip(named_leaves(pa), named_leaves(pb)):
        assert ka == kb and torch.equal(a, b), ka
    for name in ("m", "v"):
        for k, t in getattr(oa, name).items():
            assert torch.equal(t, getattr(ob, name)[k]), (name, k)
    assert torch.equal(oa.step, ob.step)
    assert la == lb


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_step_equals_the_eager_step(cuda, case):
    cfg, ocfg, n_micro, batches, mesh = _setup(cuda, case)
    runs = []
    for jit in (True, False):
        params = _model(cfg, cuda)
        step = make_train_step(cfg, ocfg, n_micro,
                               mlp_plan=lm.sparse_mlp_plan(params))
        fn = jitted_train_step(step, cuda) if jit else step
        runs.append(_run(fn, params, init_opt_state(ocfg, params), batches,
                         mesh))
        if jit:
            assert (fn.graph.captures, fn.graph.replays) == (1, STEPS - 1)
            assert fn.graph.nodes and fn.graph.pool_bytes
            fn.graph.release()
    _assert_equal_runs(*runs)


def _syncs(fn):
    """The host syncs ``fn()`` makes, under CUDA's sync debug mode: for
    each, the innermost two frames of the port (a sync in autograd's
    backward thread is reported from the ``backward`` call)."""
    seen = []

    def on_warning(message, *a, **kw):
        if "called a synchronizing" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename]
            seen.append(" < ".join(f"{os.path.basename(f.filename)}:"
                                   f"{f.lineno}" for f in frames[::-1][:2]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return seen


@pytest.mark.parametrize("case", ["qwen3", "granite", "granite_ep",
                                  "whisper", "hybrid_sparse"])
def test_host_syncs_of_the_warm_up_eager_and_replayed_steps(cuda, case):
    """The warm-up's host syncs are listed (the lazily made device arrays
    of the plans); an eager step after it, and a replayed step, make
    none."""
    cfg, ocfg, n_micro, batches, mesh = _setup(cuda, case)
    params = _model(cfg, cuda)
    step = make_train_step(cfg, ocfg, n_micro,
                           mlp_plan=lm.sparse_mlp_plan(params))
    fn = jitted_train_step(step, cuda)
    opt = init_opt_state(ocfg, params)
    with use_mesh(mesh):
        warm = _syncs(lambda: step(params, opt, batches[0]))
        print(f"\n{case}: {len(warm)} host syncs in the warm-up, at "
              f"{sorted(set(warm))}")
        assert _syncs(lambda: step(params, opt, batches[1])) == []
        fn(params, opt, batches[2])                    # the warm-up
        fn(params, opt, batches[3])                    # the capture
        assert _syncs(lambda: fn(params, opt, batches[0])) == []
    assert fn.graph.replays == 2
    fn.graph.release()


def test_loading_a_checkpoint_captures_anew(cuda, tmp_path):
    """The checkpoint's tensors are other tensors: the graph is dropped,
    the restored state warms up and is captured again, and its steps
    equal the eager step's from the same checkpoint."""
    cfg, ocfg, n_micro, batches, mesh = _setup(cuda, "qwen3")
    params = _model(cfg, cuda)
    step = make_train_step(cfg, ocfg, n_micro,
                           mlp_plan=lm.sparse_mlp_plan(params))
    fn = jitted_train_step(step, cuda)
    params, opt, _, _ = _run(fn, params, init_opt_state(ocfg, params),
                             batches[:3], None)
    assert (fn.graph.captures, fn.graph.replays) == (1, 2)
    ckpt.save(str(tmp_path), 3, {"params": params, "opt": opt})
    restored = [ckpt.load(str(tmp_path), {"params": params, "opt": opt})[1]
                for _ in range(2)]
    got = _run(fn, restored[0]["params"], restored[0]["opt"], batches, None)
    assert (fn.graph.captures, fn.graph.replays) == (2, 2 + STEPS - 1)
    want = _run(step, restored[1]["params"], restored[1]["opt"], batches,
                None)
    _assert_equal_runs(got, want)
    fn.graph.release()


def test_a_host_read_in_the_step_cannot_be_captured(cuda):
    """A step that reads the card on the host raises at its capture,
    naming the step, with the launch counts as they were, and raises
    again on the next call: nothing runs it eagerly instead."""
    cfg, ocfg, n_micro, batches, mesh = _setup(cuda, "qwen3")
    params = _model(cfg, cuda)
    inner = make_train_step(cfg, ocfg, n_micro,
                            mlp_plan=lm.sparse_mlp_plan(params))

    def step(params, opt, batch):
        out = inner(params, opt, batch)
        if float(out[2]["loss"]) < 0:          # a host read of the loss
            raise AssertionError
        return out

    step.cfg, step.mlp_plan = inner.cfg, inner.mlp_plan
    fn = jitted_train_step(step, cuda)
    opt = init_opt_state(ocfg, params)
    fn(params, opt, batches[0])                        # the warm-up
    taken = int(opt.step)
    for batch in batches[1:3]:
        counts = _counts()
        with pytest.raises(RuntimeError,
                           match="capturing the train step of qwen3-4b as "
                                 "a CUDA graph failed"):
            fn(params, opt, batch)
        assert not fn.graph.captured
        assert _counts() == counts
    torch.cuda.synchronize()
    assert int(opt.step) == taken == 1


def _sparse_launches(cfg, plan, n_micro, steps):
    """B1 and B2 launches of a partitioned sparse-MLP plan's steps: per
    layer and microbatch, B1 once a shard that holds a run for the
    forward and its remat recompute and for dB, B2 once a shard for dA."""
    b1 = lambda p: sum(int(s.runs.shape[0] > 0) for s in p.shards)
    per_layer = n_micro * cfg.n_layers * steps
    return {"maple_spmm_compact": per_layer * ((2 if cfg.remat else 1)
                                               * b1(plan.fwd) + b1(plan.bwd)),
            "maple_sddmm_bsr": per_layer * plan.fwd.n_shards}


def test_partitioned_plan_replays_equal_the_eager_step(cuda):
    """A sparse MLP under a plan partitioned over 2 shards (fewer cards
    than shards: the shards run one after another on the card) is
    captured and replayed as the single-device plan is: every step bit
    for bit the eager step's, B1 and B2 launched per shard exactly."""
    cfg, ocfg, n_micro, batches, _ = _setup(cuda, "qwen3_micro2")
    runs = []
    for jit in (True, False):
        params = _model(cfg, cuda)
        plan = lm.sparse_mlp_plan(params, n_shards=2)
        assert plan.fwd.n_shards == plan.bwd.n_shards == 2
        step = make_train_step(cfg, ocfg, n_micro, mlp_plan=plan)
        fn = jitted_train_step(step, cuda) if jit else step
        runs.append(_run(fn, params, init_opt_state(ocfg, params), batches,
                         None))
        if jit:
            assert (fn.graph.captures, fn.graph.replays) == (1, STEPS - 1)
            fn.graph.release()
    _assert_equal_runs(*runs)
    want = _sparse_launches(cfg, plan, n_micro, STEPS)
    assert {k: v for k, v in runs[0][3].items() if v} == want


def test_a_checkpoint_saved_between_replays_loads_bit_equal(cuda, tmp_path):
    """``ckpt.save`` between two replays reads the tensors the graph
    writes into: the checkpoint loads back bit-equal to them, and the
    replays after it go on as an eager run with no save in between."""
    cfg, ocfg, n_micro, batches, _ = _setup(cuda, "qwen3")
    params = _model(cfg, cuda)
    step = make_train_step(cfg, ocfg, n_micro,
                           mlp_plan=lm.sparse_mlp_plan(params))
    fn = jitted_train_step(step, cuda)
    opt = init_opt_state(ocfg, params)
    params, opt, first, _ = _run(fn, params, opt, batches[:3], None)
    ckpt.save(str(tmp_path), 3, {"params": params, "opt": opt})
    at, back = ckpt.load(str(tmp_path), {"params": params, "opt": opt})
    assert at == 3
    saved = dict(named_leaves(back["params"]))
    for k, t in named_leaves(params):
        assert torch.equal(saved[k], t), k
    for name in ("m", "v"):
        for k, t in getattr(opt, name).items():
            assert torch.equal(getattr(back["opt"], name)[k], t), (name, k)
    assert torch.equal(back["opt"].step, opt.step)
    params, opt, rest, _ = _run(fn, params, opt, batches[3:], None)
    assert (fn.graph.captures, fn.graph.replays) == (1, STEPS - 1)
    fn.graph.release()
    eager = _model(cfg, cuda)
    want = _run(make_train_step(cfg, ocfg, n_micro,
                                mlp_plan=lm.sparse_mlp_plan(eager)),
                eager, init_opt_state(ocfg, eager), batches, None)
    _assert_equal_runs((params, opt, first + rest, want[3]), want)
