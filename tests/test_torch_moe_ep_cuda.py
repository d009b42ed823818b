"""Kernels launched on their operands' card, and expert-parallel serving
across cards, on the card.

* Every kernel wrapper launches under its operands' card on that card's
  stream (``kernels._build.launch``), whichever card is current: B8's
  forward, dx and dW, B4 and B2 on ``cuda:1`` tensors while ``cuda:0`` is
  current, against their plain versions and bit for bit against the
  same launch on ``cuda:0``; the profiler sees B8's kernel on card 1.
  Needs two cards.
* granite-moe-3b's smoke config on the expert-parallel path, its tree
  placed by ``sharding.device_put_params`` on a ``(data=1, model=4)``
  mesh of four cards: prefill and decode logits and greedy tokens bit
  for bit against the one-card ``(1, 4)`` mesh on the same weights, each
  peer's B8 products on its own card, the decode step eager (no
  capture across cards).  Needs four cards.
* The same config trained across the four cards: 2 eager steps of the
  placed tree bit for bit against four ``cuda:0`` entries (losses, grad
  norms, parameters and moments), each slice's gradient on its peer's
  card, ``jitted_train_step`` the eager step there.  Needs four cards.

They import nothing of JAX and skip below their card count:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_ep_cuda.py

(on a machine with four cards for the four-card test.)
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _cards(n: int):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPUs (CUDA kernels have no CPU "
                    f"mode)")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.fixture
def two_cards():
    return _cards(2)


@pytest.fixture
def four_cards():
    return _cards(4)


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max())
    limit = 1e-5 * scale + 1e-6 if dtype == torch.float32 else 1e-2 * scale
    assert float((got - want).abs().max()) <= limit


def _kernel_devices(fn):
    """The device index of every B8 kernel ``fn`` launches, by the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    return {e.device_index() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and "moe_kernel" in e.name()}


def _moe_calls(dev, dtype):
    """B8 forward, dx and dW at a tile of 16 over three experts (one with
    no tile), their plain versions and their launch counts."""
    from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_dw,
                                              moe_gemm_dw_plain, moe_gemm_dx,
                                              moe_gemm_dx_plain,
                                              moe_gemm_plain)
    rng = np.random.default_rng(3)
    x, dy = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .to(dev, dtype) for s in ((48, 64), (48, 96)))
    w = torch.from_numpy((rng.standard_normal((3, 64, 96)) * 0.1)
                         .astype(np.float32)).to(dev, dtype)
    eot = torch.tensor([2, 0, 2], dtype=torch.int32, device=dev)
    with torch.no_grad():
        got = {"forward": moe_gemm(x, eot, w, bt=16),
               "dx": moe_gemm_dx(dy, eot, w, bt=16),
               "dw": moe_gemm_dw(x, dy, eot, 3, bt=16)}
    want = {"forward": moe_gemm_plain(x, eot, w, bt=16),
            "dx": moe_gemm_dx_plain(dy, eot, w, bt=16),
            "dw": moe_gemm_dw_plain(x, dy, eot, 3, bt=16)}
    return got, want


def _spmm_calls(dev, dtype):
    """B4 on a plan with split rows and B2 over its slots, against their
    plain versions."""
    from repro_torch.core.csr import BlockCSR
    from repro_torch.kernels import (maple_sddmm_bsr, maple_spmm_planned,
                                     plan_spmm)
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr_plain
    from repro_torch.kernels.maple_spmm import maple_spmm_planned_plain
    rng = np.random.default_rng(11)
    mask = rng.random((9, 8)) < 0.5
    mask[1::3] = False
    d = rng.standard_normal((9 * 16, 8 * 32)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, 16, 0), 32, 1)
    a = BlockCSR.from_dense(d, (16, 32), n_blocks_max=int(mask.sum()) + 3,
                            device=dev)
    a = dataclasses.replace(a, blocks=a.blocks.to(dtype))
    plan = plan_spmm(a, n_lanes=3, chunk=2)
    b3 = torch.from_numpy(rng.standard_normal((2, a.shape[1], 70))
                          .astype(np.float32)).to(dev, dtype)
    dc = torch.from_numpy(rng.standard_normal((2, a.shape[0], 70))
                          .astype(np.float32)).to(dev, dtype)
    meta = plan.on_device(dev)
    args = (a.blocks, meta["order"], meta["step_col"], meta["row_runs"],
            meta["row_run_ptr"], b3)
    br = torch.from_numpy(a.block_row).to(dev)
    bc = torch.from_numpy(a.block_col).to(dev)
    got = {"b4": maple_spmm_planned(*args, bn=64),
           "b2": maple_sddmm_bsr(dc, b3, br, bc, bm=16, bk=32, bn=64)}
    want = {"b4": maple_spmm_planned_plain(*args),
            "b2": maple_sddmm_bsr_plain(dc, b3, br, bc, bm=16, bk=32)}
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_launch_on_the_operands_card(two_cards, dtype):
    """With ``cuda:0`` current, B8 (forward, dx, dW), B4 and B2 on
    ``cuda:1`` tensors launch on card 1: their outputs live there, match
    the plain versions, and equal the same launches on ``cuda:0`` bit for
    bit; the current card stays 0, and B8's kernel runs on card 1."""
    from repro_torch.kernels.moe_gemm import moe_gemm
    zero, one = two_cards
    torch.cuda.set_device(zero)
    results = {}
    for dev in (one, zero):
        got, want = _moe_calls(dev, dtype)
        got2, want2 = _spmm_calls(dev, dtype)
        got.update(got2)
        want.update(want2)
        for i in range(2):
            torch.cuda.synchronize(i)
        assert torch.cuda.current_device() == 0
        for name, t in got.items():
            assert t.device == dev, name
            _close(t, want[name], dtype)
        results[dev.index] = {k: v.cpu() for k, v in got.items()}
    for name, t in results[1].items():
        assert torch.equal(t, results[0][name]), name
    x = torch.randn((16, 64), device=one).to(dtype)
    w = torch.randn((2, 64, 64), device=one).to(dtype)
    eot = torch.tensor([1], dtype=torch.int32, device=one)
    before = moe_gemm.launches
    seen = _kernel_devices(lambda: moe_gemm(x, eot, w, bt=16))
    assert moe_gemm.launches == before + 1
    assert seen == {1}, seen


def test_granite_ep_on_four_cards_equals_one_card(four_cards):
    """granite-moe-3b's smoke config (EP, capacity 1.25): the tree placed
    on a (1, 4) mesh of four cards serves ``generate`` with the prefill
    and every decode step's logits and the tokens bit for bit equal to
    the one-card (1, 4) mesh's on the same weights; B8 launches 3 a peer
    a layer a forward in both; cards 1 to 3 hold their peer's expert
    slices and nothing else of the tree; the decode steps run eagerly."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.serve import SamplingConfig, engine, generate
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              moe_impl="ep_a2a", moe_capacity_factor=1.25)
    home = four_cards[0]
    torch.cuda.set_device(home)
    params = lm.init_params(cfg, torch.Generator(device=home).manual_seed(0),
                            device=home)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 11))).to(home)
    new = 6
    runs = {}
    meshes = {"one": make_debug_mesh((1, 4), device="cuda:0"),
              "four": make_debug_mesh((1, 4))}
    assert len(sh.mesh_devices(meshes["four"])) == 4
    before = [torch.cuda.memory_allocated(i) for i in range(4)]
    placed = sh.device_put_params(params, meshes["four"])
    moe = placed["groups"]["b0"]["moe"]
    for i in range(1, 4):       # cards 1 to 3 hold their peer's slices only
        own = sum(-(-moe[n].parts[i].nbytes // 512) * 512
                  for n in sh.EXPERT_LEAVES)
        assert torch.cuda.memory_allocated(i) - before[i] == own
    for pe, part in enumerate(
            placed["groups"]["b0"]["moe"]["experts_gate"].parts):
        assert part.device == four_cards[pe]
        assert part.shape[1] == cfg.n_experts_padded // 4
    step = engine.jitted_decode_step(cfg)
    sample = engine.sample_token
    for name, tree in (("one", params), ("four", placed)):
        seen = []

        def record(logits, *a, **kw):
            seen.append(logits.cpu())
            return sample(logits, *a, **kw)
        engine.sample_token = record
        moe_gemm.launches = 0
        captures = step.graph.captures
        try:
            with sh.use_mesh(meshes[name]):
                tokens, _ = generate(tree, cfg, {"tokens": prompts},
                                     SamplingConfig(max_new_tokens=new))
                for i in range(4):
                    torch.cuda.synchronize(i)
        finally:
            engine.sample_token = sample
        runs[name] = (tokens.cpu(), seen, moe_gemm.launches,
                      step.graph.captures - captures)
        engine.release_graphs()
    (tok1, lg1, n1, cap1), (tok4, lg4, n4, cap4) = runs["one"], runs["four"]
    assert n1 == n4 == 3 * 4 * cfg.n_layers * (1 + new)
    assert (cap1, cap4) == (1, 0)       # one card captures; four run eagerly
    assert len(lg1) == len(lg4) == new
    assert torch.equal(tok1, tok4)
    for a, b in zip(lg1, lg4):
        assert torch.equal(a, b)


def test_granite_ep_trains_on_four_cards_like_one_card(four_cards):
    """granite-moe-3b's smoke config (EP, capacity 1.25) trained from one
    draw, placed on four ``cuda:0`` entries and on four cards: 2 eager
    steps give the same losses and grad norms, and the same parameters
    and moments, bit for bit; under the four cards a backward leaves each
    slice's gradient on its peer's card, and ``jitted_train_step`` is the
    eager step itself."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   jitted_train_step, make_train_step)
    from repro_torch.train.optimizer import named_leaves, parts
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              moe_impl="ep_a2a", moe_capacity_factor=1.25)
    home = four_cards[0]
    torch.cuda.set_device(home)
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                      global_batch=4, seed=0)
    step = make_train_step(cfg, ocfg, micro_batches=2)
    meshes = {"one": make_debug_mesh((1, 4), device="cuda:0"),
              "four": make_debug_mesh((1, 4))}
    runs = {}
    for name, mesh in meshes.items():
        params = sh.device_put_params(lm.unstack_layers(lm.init_params(
            cfg, torch.Generator(device=home).manual_seed(0), device=home)),
            mesh)
        opt = init_opt_state(ocfg, params)
        metrics = []
        with sh.use_mesh(mesh):
            for s in range(2):
                batch = {k: v.to(home) for k, v in synth_batch(dcfg, s).items()}
                params, opt, m = step(params, opt, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        state = {f"{tag}/{k}": [t.detach().cpu() for t in parts(leaf)]
                 for tag, tree in (("p", params), ("m", opt.m), ("v", opt.v))
                 for k, leaf in named_leaves(tree)}
        runs[name] = (metrics, state, params)
    (m1, s1, _), (m4, s4, placed) = runs["one"], runs["four"]
    assert m1 == m4
    assert s1.keys() == s4.keys()
    for k, want in s1.items():
        assert all(torch.equal(a, b) for a, b in zip(s4[k], want)), k
    mesh = meshes["four"]
    batch = {k: v.to(home) for k, v in synth_batch(dcfg, 2).items()}
    leaves = [t for _, leaf in named_leaves(placed) for t in parts(leaf)]
    for t in leaves:
        t.requires_grad_(True)
    with sh.use_mesh(mesh):
        loss, _ = lm.loss_fn(placed, cfg, batch)
        loss.backward()
        assert jitted_train_step(step, home) is step
    for _, leaf in named_leaves(placed):
        if isinstance(leaf, sh.PeerSlices):
            for pe, part in enumerate(leaf.parts):
                assert part.device == four_cards[pe]
                assert part.grad is not None
                assert part.grad.device == four_cards[pe]
