"""Captured serving steps on the card: each kernel launcher of the decode
path (B1, B3, B4, B8) inside a CUDA graph capture, and the decode
callables (``serve.jitted_decode_step``, the batcher's fused step)
replayed against the eager step on copies of one state, bit for bit
(outputs and every cache); a recapture when other caches are handed in;
exact launch counts across replays; one host sync a fused step.

These tests need an NVIDIA GPU and the CUDA toolkit (``nvcc``); without a
card they skip.  They import nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs_cuda.py
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels import (launch_counters, maple_spmm_compact,
                                 maple_spmm_naive, maple_spmm_planned,
                                 plan_spmm)
from repro_torch.kernels.ops import _meta_on
from repro_torch.models import lm
from repro_torch.models.layers import init_sparse_linear
from repro_torch.serve import (BatcherConfig, ContinuousBatcher, Request,
                               RequestQueue, SparseLogitHead,
                               jitted_decode_step)
from repro_torch.serve.engine import release_graphs
from repro_torch.serve.graphs import StepGraph

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    yield torch.device("cuda")
    release_graphs()


def _captured(fn):
    """``fn()`` eagerly (the warm-up), then captured and replayed twice:
    (eager result, replayed result)."""
    want = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, out)
    return want, out


def _sparse(cuda, block, dtype, gm=9, gk=8, seed=3):
    rng = np.random.default_rng(seed)
    bm, bk = block
    mask = rng.random((gm, gk)) < 0.5
    mask[1::3] = False
    d = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    a = BlockCSR.from_dense(d, block, device=cuda)
    return dataclasses.replace(a, blocks=a.blocks.to(dtype)), rng


@pytest.mark.parametrize("dtype,block,g,n", [
    (torch.float32, (8, 8), 2, 4), (torch.float32, (64, 64), 1, 4),
    (torch.bfloat16, (64, 64), 1, 1), (torch.bfloat16, (64, 64), 8, 1)])
def test_run_walk_launches_capture_and_replay(cuda, dtype, block, g, n):
    """B3, B1 and B4 captured at decode's shapes replay what they
    computed eagerly, bit for bit."""
    a, rng = _sparse(cuda, block, dtype)
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    meta = _meta_on(a, cuda)
    bn = 16 if block == (8, 8) else 128
    want, got = _captured(lambda: maple_spmm_naive(
        a.blocks, meta["row_ptr"], meta["block_col"], b3, bn=bn))
    assert torch.equal(want, got)
    plan = plan_spmm(a, n_lanes=8, chunk=2)
    dev = plan.on_device(cuda)
    want, got = _captured(lambda: maple_spmm_planned(
        a.blocks, dev["order"], dev["step_col"], dev["row_runs"],
        dev["row_run_ptr"], b3, bn=bn))
    assert torch.equal(want, got)
    # B1 writes only the slots its runs name: both calls fill zeros
    slots = plan.n_lanes * plan.r_max
    shape = (g, slots * block[0], n)
    eager, captured = (torch.zeros(shape, device=cuda) for _ in range(2))
    maple_spmm_compact(a.blocks, dev["order"], dev["step_col"], dev["runs"],
                       b3, n_slots=slots, bn=bn, out=eager)
    _, got = _captured(lambda: maple_spmm_compact(
        a.blocks, dev["order"], dev["step_col"], dev["runs"], b3,
        n_slots=slots, bn=bn, out=captured))
    assert torch.equal(eager, got) and got.data_ptr() == captured.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,d,f,bt", [
    ([8] * 48, 1536, 512, 8),                   # granite decode: TMA
    ([16, 16, 0], 70, 44, 16)])                 # the producer's copies
def test_moe_gemm_launch_captures_and_replays(cuda, dtype, sizes, d, f, bt):
    from repro_torch.kernels import moe_expert_gemm
    rng = np.random.default_rng(5)
    t = int(np.sum(sizes))
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((len(sizes), d, f))
                         .astype(np.float32) * 0.1)
    x, w = x.to(cuda, dtype), w.to(cuda, dtype)
    gs = torch.tensor(sizes, device=cuda)
    want, got = _captured(lambda: moe_expert_gemm(x, gs, w, bt=bt))
    assert torch.equal(want, got)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        if isinstance(v, dict):
            _assert_states_equal(v, want[k])
        elif torch.is_tensor(v):
            assert torch.equal(v, want[k]), k
        else:
            assert v == want[k], k


def _model(cuda, arch, **over):
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    gen = torch.Generator(device=cuda).manual_seed(0)
    return cfg, lm.init_params(cfg, gen, device=cuda)


def _extras(cfg, b, cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    out = {}
    if cfg.n_enc_layers:
        out["enc_frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model),
                                        generator=gen, device=cuda)
    if cfg.n_patches:
        out["vision_embeds"] = torch.randn((b, cfg.n_patches, cfg.d_model),
                                           generator=gen, device=cuda)
    return out


def _replay_against_eager(cfg, params, state, tok, steps, *,
                          return_hidden=False):
    """``steps`` calls of the cached decode callable on ``state`` against
    the eager ``lm.decode_step`` on a copy of it, fed the same greedy
    tokens: outputs and every cache equal after each step.  Returns the
    (captures, replays) the calls made."""
    fn = jitted_decode_step(cfg, return_hidden=return_hidden)
    before = fn.graph.captures, fn.graph.replays
    other = _clone(state)
    for _ in range(steps):
        out, state = fn(params, state=state, tokens=tok)
        want, other = lm.decode_step(params, cfg, other, tok,
                                     return_hidden=return_hidden)
        assert torch.equal(out, want)
        _assert_states_equal(state, other)
        assert isinstance(state["pos"], int)
        tok = out[:, -1, :cfg.vocab_size].argmax(-1)[:, None] \
            if not return_hidden else tok
    return (fn.graph.captures - before[0], fn.graph.replays - before[1])


@pytest.mark.parametrize("return_hidden", [False, True])
@pytest.mark.parametrize("arch,over,prompt", [
    ("qwen3-4b", dict(sparse_mlp=True, sparse_block=(8, 8)), 9),
    ("recurrentgemma-9b", dict(sparse_mlp=True, sparse_block=(8, 8)), 14),
    ("granite-moe-3b-a800m", {}, 9),
    ("whisper-base", {}, 7),
    ("internvl2-1b", {}, 5),
    ("mamba2-2.7b", {}, 8)])
def test_decode_callable_replays_the_eager_step(cuda, arch, over, prompt,
                                                return_hidden):
    """Warm-up, capture, then replays: each step equal to the eager one on
    a copy of the state (recurrentgemma-9b runs past its window)."""
    cfg, params = _model(cuda, arch, **over)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, prompt))).to(cuda)
    _, state = lm.prefill(params, cfg, {"tokens": tok, **_extras(cfg, 2,
                                                                 cuda)},
                          max_seq=prompt + cfg.n_patches + 10)
    assert _replay_against_eager(cfg, params, state, tok[:, -1:], 8,
                                 return_hidden=return_hidden) == (1, 7)


def test_paged_decode_callable_replays_the_eager_step(cuda):
    cfg, params = _model(cuda, "qwen3-4b", sparse_mlp=True,
                         sparse_block=(8, 8))
    state = lm.init_paged_state(cfg, 4, 12, 4, 4, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for name in ("k", "v"):
        t = state["groups"]["b0"][name]
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
    state["table"].copy_(torch.arange(1, 17, device=cuda).view(4, 4) % 12)
    state["pos"].copy_(torch.tensor([0, 3, 5, 9], device=cuda))
    fn = jitted_decode_step(cfg, paged=True)
    before = fn.graph.captures, fn.graph.replays
    other = _clone(state)
    tok = torch.tensor([[1], [2], [3], [4]], device=cuda)
    for _ in range(6):
        out, state = fn(params, state=state, tokens=tok)
        want, other = lm.decode_step_paged(params, cfg, other, tok)
        assert torch.equal(out, want)
        _assert_states_equal(state, other)
        tok = out[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    assert (fn.graph.captures - before[0],
            fn.graph.replays - before[1]) == (1, 5)


def test_other_caches_are_captured_anew(cuda):
    """A graph holds the caches it was captured on: handed another state
    it drops the graph, warms up on the new caches and captures again,
    and the first state's caches are left alone."""
    cfg, params = _model(cuda, "qwen3-4b", sparse_mlp=True,
                         sparse_block=(8, 8))
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 6))).to(cuda)
    _, a = lm.prefill(params, cfg, {"tokens": tok}, max_seq=20)
    _, b = lm.prefill(params, cfg, {"tokens": tok.flip(1)}, max_seq=20)
    assert _replay_against_eager(cfg, params, a, tok[:, -1:], 3) == (1, 2)
    kept = _clone(a)
    assert _replay_against_eager(cfg, params, b, tok[:, :1], 4) == (1, 3)
    _assert_states_equal(a, kept)


def test_replays_count_every_launch(cuda):
    """The wrappers count in Python: a capture's increments are undone
    and its count added on each replay, so a run counts as the eager
    step does (B3 a layer a step)."""
    cfg, params = _model(cuda, "qwen3-4b", sparse_mlp=True,
                         sparse_block=(8, 8))
    tok = torch.ones((1, 4), dtype=torch.long, device=cuda)
    _, state = lm.prefill(params, cfg, {"tokens": tok}, max_seq=12)
    fn = jitted_decode_step(cfg)
    before = maple_spmm_naive.launches, fn.graph.replays
    for _ in range(5):
        _, state = fn(params, state=state, tokens=tok[:, :1])
    assert maple_spmm_naive.launches - before[0] == 5 * cfg.n_layers
    assert fn.graph.replays - before[1] == 4


def test_a_capture_that_fails_raises(cuda):
    """A step that reads the card on the host cannot be captured: the
    call says so and does not fall back to the eager step."""
    graph = StepGraph("a step with a host read")
    x = torch.ones(4, device=cuda)

    def fn(feeds):
        return x * float(feeds["v"].sum())

    graph(fn, {"v": 1}, (x,), cuda)                    # warm-up
    counts = {k: f.launches for k, f in launch_counters().items()}
    with pytest.raises(RuntimeError, match="capturing a step with"):
        graph(fn, {"v": 1}, (x,), cuda)
    assert not graph.captured
    assert counts == {k: f.launches for k, f in launch_counters().items()}


def test_batcher_fused_step_is_one_graph_with_one_host_sync(cuda):
    """The fused step and the head replay as one graph; a round reads the
    card once (the draw), under ``set_sync_debug_mode``."""
    cfg, params = _model(cuda, "qwen3-4b", sparse_mlp=True,
                         sparse_block=(8, 8))
    gen = torch.Generator(device=cuda).manual_seed(5)
    head = SparseLogitHead.build(init_sparse_linear(
        gen, cfg.d_model, cfg.vocab_padded, block_shape=(8, 8),
        block_density=0.5))
    rng = np.random.default_rng(6)
    queue = RequestQueue()
    for rid in range(4):
        queue.submit(Request(tokens=rng.integers(0, cfg.vocab_size, 5)
                           .astype(np.int32), max_new_tokens=12,
                           arrival=0.0, rid=rid))
    eng = ContinuousBatcher(params, cfg, queue,
                            BatcherConfig(max_slots=4, page_size=4,
                                          n_pages=24, max_seq=24),
                            head=head)
    for t in range(3):
        eng.step(float(t))
    assert eng.graph.captures == 1 and eng.graph.replays == 2
    syncs = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda msg, *a, **k: syncs.append(str(msg))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step(3.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [m for m in syncs if "called a synchronizing" in m]
    assert len(syncs) == 1, syncs
    assert eng.graph.replays == 3
