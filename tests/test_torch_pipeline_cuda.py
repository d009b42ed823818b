"""The GPipe pipeline with each stage's layer groups on its own card, on
the cards.

qwen2-72b's smoke config cut to 8 layers (bf16 parameters, QKV biases
drawn, a sparse MLP at (8, 8)) through ``pipeline_apply`` over a
``("pod",)`` mesh of the cards (four where there are four, else two),
its tree placed by ``pipeline.place_stages``: output, dx and every
gradient of ``sum(y·R)`` bit for bit against the same tree on as many
``cuda:0`` entries, each layer's ``.grad`` on its stage's card, and the
unplaced tree refused.  The placed tree's checkpoint loads back onto the
cards its ``like`` names, bit for bit.  Needs two cards.

It imports nothing of JAX and skips below two cards:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_pipeline_cuda.py
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 NVIDIA GPUs (CUDA kernels have no CPU mode)")
    n = 4 if torch.cuda.device_count() >= 4 else 2
    return [torch.device("cuda", i) for i in range(n)]


def _smoke(seed=0):
    """The 8-layer qwen2-72b smoke tree on ``cuda:0`` drawn from
    ``seed``, its plan, x and R (4 × 16 tokens)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"), n_layers=8,
                              sparse_mlp=True, sparse_block=(8, 8))
    gen = torch.Generator(device="cuda:0").manual_seed(seed)
    layers = lm.unstack_layers(lm.init_params(
        cfg, gen, torch.bfloat16, device="cuda:0"))["groups"]["b0"]
    for layer in layers:
        for k in ("bq", "bk", "bv"):
            layer["attn"][k].normal_(generator=gen).mul_(0.5)
    x = torch.randn((4, 16, cfg.d_model), generator=gen,
                    device="cuda:0").to(torch.bfloat16)
    r = torch.randn(x.shape, generator=gen, device="cuda:0").to(x.dtype)
    return cfg, layers, lm.sparse_mlp_plan(layers), x, r


def _run(cfg, plan, tree, mesh, x, r):
    """y, dx and the leaves' gradients of ``sum(y·R)`` through the
    pipeline (4 microbatches), the leaves' ``.grad`` cleared after."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models import lm
    from repro_torch.train.optimizer import named_leaves
    leaves = [t for _, t in named_leaves(tree)]
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    xg = x.clone().requires_grad_(True)
    y = pipeline_apply(lambda stage, h: lm.apply_layers(
        stage, cfg, h, mlp_plan=plan), mesh, 4, tree, xg)
    (y * r).sum().backward()
    grads = [t.grad for t in leaves]
    for t in leaves:
        t.grad = None
    return y.detach(), xg.grad, grads


def test_placed_on_the_cards_equals_one_card(cards):
    from repro_torch.distributed.pipeline import pipeline_apply, place_stages
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.train.optimizer import named_leaves
    cfg, layers, plan, x, r = _smoke()
    n = len(cards)
    one = Mesh(["cuda:0"] * n, ("pod",))
    mesh = Mesh([str(c) for c in cards], ("pod",))
    y0, dx0, g0 = _run(cfg, plan, layers, one, x, r)
    with pytest.raises(ValueError, match="place_stages"):
        pipeline_apply(lambda s, h: h, mesh, 4, layers, x)
    placed = place_stages(layers, mesh)
    y1, dx1, g1 = _run(cfg, plan, placed, mesh, x, r)
    assert torch.equal(y1, y0) and torch.equal(dx1, dx0)
    per_layer = len(list(named_leaves(layers[0])))
    per = cfg.n_layers // n
    for i, (a, b) in enumerate(zip(g1, g0)):
        assert a.device == cards[i // per_layer // per], i
        assert torch.equal(a.to(b.device), b), i


def test_placed_checkpoint_loads_onto_the_cards(cards, tmp_path):
    from repro_torch.distributed.pipeline import place_stages
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.train.optimizer import named_leaves
    _, layers, _, _, _ = _smoke()
    mesh = Mesh([str(c) for c in cards], ("pod",))
    placed = place_stages(layers, mesh)
    ckpt.save(str(tmp_path), 1, placed)
    like = place_stages(_smoke(seed=1)[1], mesh)     # other values
    _, got = ckpt.load(str(tmp_path), like)
    for (k, a), (_, b), (_, c) in zip(named_leaves(got),
                                      named_leaves(placed),
                                      named_leaves(like)):
        assert a.device == b.device == c.device, k
        assert torch.equal(a, b), k
