"""Training on the expert-parallel path with each ``model`` peer's experts
placed on its own device (``sharding.device_put_params``), on the CPU.

The CPU mesh's entries stand for several devices through
``sharding.several`` (the MoE layer then takes its path of several devices:
each peer's rows copied to its slices' device, the slices checked to lie
there) while every slice stays a CPU tensor, so the placed tree trains
here as it does across cards:

* one ``make_train_step`` step of granite-moe-3b's smoke config on the
  placed tree against the whole tree on the same ``(1, 4)`` mesh: the
  loss within 1e-6 relative and every parameter within 1e-6·max (the
  global norm sums the placed slices in another order, the one
  difference); every expert slice moved by the step;
* the optimizer over placed leaves: one path a leaf, moments cut alike on
  each slice's device, the global norm's order;
* ``jitted_train_step`` returns the eager step on a mesh of several
  cards (no card is touched: the rule reads the mesh's entries).

Bit-for-bit resume of a placed run is in ``test_torch_checkpoint.py``;
the same steps on four cards in ``test_torch_moe_ep_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, synth_batch
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               jitted_train_step, make_train_step)
from repro_torch.train.optimizer import (global_norm, named_leaves, parts,
                                         tree_map)
from repro_torch.train.train_step import CapturedTrainStep

ARCH = "granite-moe-3b-a800m"


def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH), moe_impl="ep_a2a",
                               moe_capacity_factor=1.25)


def _tree(cfg):
    return lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))


def _stand_in(monkeypatch):
    """The CPU mesh counted as several devices by the MoE layer; returns
    the list its calls append to."""
    seen = []

    def several(mesh):
        seen.append(mesh)
        return True
    monkeypatch.setattr(sh, "several", several)
    return seen


@pytest.mark.timeout(300)
def test_placed_step_matches_the_whole_tree(monkeypatch):
    cfg = _cfg()
    mesh = make_debug_mesh((1, 4), device="cpu")
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=1), 0)
    step = make_train_step(cfg, ocfg, micro_batches=2)
    runs = {}
    for name in ("whole", "placed"):
        params = _tree(cfg)
        if name == "placed":
            params = sh.device_put_params(params, mesh)
            seen = _stand_in(monkeypatch)
        before = {k: [t.clone() for t in parts(v)]
                  for k, v in named_leaves(params)}
        opt = init_opt_state(ocfg, params)
        with sh.use_mesh(mesh):
            params, opt, metrics = step(params, opt, batch)
        runs[name] = (params, opt, metrics, before)
    # every layer of both microbatches, forward and remat's recompute
    assert len(seen) == cfg.n_layers * 2 * 2
    whole, _, m_whole, _ = runs["whole"]
    placed, opt, m_placed, before = runs["placed"]
    loss = float(m_whole["loss"])
    assert abs(float(m_placed["loss"]) - loss) <= 1e-6 * abs(loss)
    gn = float(m_whole["grad_norm"])
    assert abs(float(m_placed["grad_norm"]) - gn) <= 1e-6 * gn
    got = dict(named_leaves(placed))
    n_placed = 0
    for k, want in named_leaves(whole):
        leaf = got[k]
        if isinstance(leaf, sh.PeerSlices):
            n_placed += 1
            for part, was in zip(leaf.parts, before[k]):
                assert not torch.equal(part, was), k     # every slice moved
                assert part.grad is None
            assert isinstance(opt.m[k], sh.PeerSlices)
            leaf = leaf.whole()
        err = float((leaf.detach() - want.detach()).abs().max())
        assert err <= 1e-6 * float(want.detach().abs().max()), k
    assert n_placed == 3 * cfg.n_layers


def test_optimizer_state_over_placed_leaves():
    """A placed leaf is one leaf under its whole path; its moments are cut
    alike, each slice on its peer's device (``meta`` entries stand for
    other devices); the step count and the residuals of an uncompressed
    leaf live on the first leaf's device."""
    cfg = _cfg()
    mesh = sh.Mesh([["cpu", "meta", "meta", "meta"]], ("data", "model"))
    placed = sh.device_put_params(_tree(cfg), mesh)
    leaves = dict(named_leaves(placed))
    whole = dict(named_leaves(_tree(cfg)))
    assert list(leaves) == list(whole)
    for compress in (False, True):
        opt = init_opt_state(OptimizerConfig(compress_grads=compress), placed)
        assert opt.step.device.type == "cpu"
        for k, leaf in leaves.items():
            if not isinstance(leaf, sh.PeerSlices):
                continue
            assert leaf.shape == tuple(whole[k].shape)
            for moments in (opt.m, opt.v) + ((opt.error,) if compress
                                             else ()):
                got = moments[k]
                assert isinstance(got, sh.PeerSlices)
                assert got.axis == leaf.axis and got.shape == leaf.shape
                for pe, part in enumerate(got.parts):
                    assert part.device == mesh.device_at(model=pe)
                    assert part.shape == leaf.parts[pe].shape
            if not compress:
                assert opt.error[k].shape == ()
                assert opt.error[k].device.type == "cpu"


def test_global_norm_sums_placed_slices_in_peer_order():
    """The norm of a placed tree is the square root of the leaves' sums of
    squares added in ``named_leaves`` order, a placed leaf's slices in
    peer order; within 1e-6 of the whole tree's."""
    rng = np.random.default_rng(2)
    whole = {"a": torch.from_numpy(rng.standard_normal((5, 3)).astype(
        np.float32)),
             "experts_up": torch.from_numpy(rng.standard_normal(
                 (8, 4, 6)).astype(np.float32))}
    placed = sh.device_put_params(whole, make_debug_mesh((1, 4),
                                                         device="cpu"))
    assert isinstance(placed["experts_up"], sh.PeerSlices)
    total = torch.sum(torch.square(whole["a"]))
    for part in placed["experts_up"].parts:
        total = total + torch.sum(torch.square(part))
    assert torch.equal(global_norm(placed), torch.sqrt(total))
    want = float(global_norm(whole))
    assert abs(float(global_norm(placed)) - want) <= 1e-6 * want
    grads = tree_map(lambda t: 2 * t, placed)
    assert isinstance(grads["experts_up"], sh.PeerSlices)
    assert torch.equal(grads["experts_up"].whole(), 2 * whole["experts_up"])


def test_train_step_captures_only_on_one_card():
    """``jitted_train_step`` shares the serving steps' rule
    (``serve.graphs.captured``): on a card it captures under no mesh or a
    mesh whose entries are all one card, and returns the eager step under
    a mesh of several cards and on the CPU; a captured step called under
    a mesh of several cards runs eagerly too."""
    calls = []

    def step(params, opt, batch):
        calls.append(batch)
        return params, opt, {}
    step.cfg, step.mlp_plan = _cfg(), None
    one = sh.Mesh([["cuda:0"] * 4], ("data", "model"))
    four = sh.Mesh([[f"cuda:{i}" for i in range(4)]], ("data", "model"))
    assert isinstance(jitted_train_step(step, "cuda:0"), CapturedTrainStep)
    assert jitted_train_step(step, "cpu") is step
    with sh.use_mesh(one):
        fn = jitted_train_step(step, "cuda:0")
        assert isinstance(fn, CapturedTrainStep)
    with sh.use_mesh(four):
        assert jitted_train_step(step, "cuda:0") is step
        assert fn(1, 2, "batch") == (1, 2, {})
    assert calls == ["batch"]
