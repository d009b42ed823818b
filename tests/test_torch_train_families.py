"""Port parity of training the audio, vlm, MoE and SSM families: the smoke
configs of whisper-base (encoder, cross-attention, layer norms, GELU
MLPs), internvl2-1b (the vision prefix; dense, and with a block-sparse
MLP at (8, 8) blocks), granite-moe-3b-a800m (expert products on B8's
forward and backward) and mamba2-2.7b (the SSD scan through autograd),
against ``repro`` on the CPU.

Parameters are initialised by the reference (biases drawn non-zero) and
carried across with ``repro_torch.convert`` into the trainer's per-layer
layout.  One batch, built with numpy (tokens, labels and the encoder
frames or patch embeddings), goes to both packages, since the two
``synth_batch``es draw the extra inputs differently.

Tolerances, as ``test_torch_train``'s: the loss within 1e-5 relative;
every gradient leaf within 1e-4·max|ref| + 1e-6 (f32 sums in another
order through a whole model); the parameters after one AdamW step within
2·lr (Adam's first step is sign-like).  Remat on and off give the same
loss and gradients within 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro.models import lm as ref_lm
from repro_torch.configs import get_smoke_config
from repro_torch.core.csr import BlockCSR
from repro_torch.models import lm
from repro_torch.train import (OptimizerConfig, apply_updates,
                               init_opt_state, make_train_step)
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.optimizer import named_leaves, tree_map
from test_torch_encdec import extras, models
from test_torch_train import LR, _ref_grads, port_leaves, ref_leaves

# case id: (arch, config overrides, sequence length of the tokens)
CASES = {"whisper": ("whisper-base", {}, 16),
         "internvl": ("internvl2-1b", {}, 16),
         "internvl_sparse": ("internvl2-1b",
                             dict(sparse_mlp=True, sparse_block=(8, 8)), 16),
         "granite": ("granite-moe-3b-a800m", {}, 16),
         "mamba2": ("mamba2-2.7b", {}, 64)}       # two SSD chunks of 32
BATCH = 2


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch, over, seq = CASES[request.param]
    cfg_ref, cfg, params_ref, stacked = models(arch, 3, **over)
    rng = np.random.default_rng(11)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, seq + 1)).astype(np.int32)
    batch_np = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
                **extras(cfg, BATCH, 5)}
    batch_np["labels"][0, :3] = -1                 # masked positions too
    batch_ref = {k: jnp.asarray(v) for k, v in batch_np.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    return dict(cfg_ref=cfg_ref, cfg=cfg, params_ref=params_ref,
                stacked=stacked, batch_ref=batch_ref, batch=batch)


def stack_layers(tree):
    """The trainer's per-layer lists (parameters or gradients) back in
    the stacked layout, as the reference names its leaves: the groups,
    the tail and the encoder's groups."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        if isinstance(first, BlockCSR):
            return dataclasses.replace(
                first, blocks=torch.stack([it.blocks for it in items]),
                device_meta={})
        return torch.stack(items)

    def groups(node):
        return {name: stack(group) for name, group in node.items()}

    out = dict(tree)
    for key in ("groups", "tail"):
        if key in tree:
            out[key] = groups(tree[key])
    if "encoder" in tree:
        out["encoder"] = dict(tree["encoder"],
                              groups=groups(tree["encoder"]["groups"]))
    return out


def _params(c):
    return lm.unstack_layers(tree_map(lambda t: t.clone(), c["stacked"]))


def _plan(c, params):
    return lm.sparse_mlp_plan(params)


def _grads(c, remat):
    params = _params(c)
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    loss, _ = lm.loss_fn(params, c["cfg"], c["batch"], remat=remat,
                         mlp_plan=_plan(c, params))
    loss.backward()
    return loss.detach(), {k: t.grad.clone() for k, t in
                           named_leaves(params)}


def test_loss_equals_reference(case):
    c = case
    ref_plan = ref_lm.sparse_mlp_plan(c["params_ref"])
    want, want_aux = jax.jit(lambda p: ref_lm.loss_fn(
        p, c["cfg_ref"], c["batch_ref"], mlp_plan=ref_plan))(c["params_ref"])
    params = _params(c)
    for remat in (True, False):
        got, aux = lm.loss_fn(params, c["cfg"], c["batch"], remat=remat,
                              mlp_plan=_plan(c, params))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(float(aux["z_loss"]),
                                   float(want_aux["z_loss"]), rtol=1e-5)
        assert int(aux["tokens"]) == int(want_aux["tokens"])
    # a vision prefix carries no loss: its positions are masked
    assert int(aux["tokens"]) == int((c["batch"]["labels"] >= 0).sum())
    logits = lm.forward(params, c["cfg"], c["batch"])
    assert logits.shape[1] == c["cfg"].n_patches + \
        c["batch"]["tokens"].shape[1]


def test_remat_on_and_off_give_the_same_grads(case):
    loss_on, on = _grads(case, True)
    loss_off, off = _grads(case, False)
    np.testing.assert_allclose(float(loss_on), float(loss_off), rtol=1e-6)
    assert set(on) == set(off)
    for k, g in on.items():
        scale = float(off[k].abs().max())
        assert float((g - off[k]).abs().max()) <= 1e-6 * scale + 1e-7, k


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_grads_and_params_match_reference(case, n_micro,
                                                     monkeypatch):
    c = case
    ref_plan = ref_lm.sparse_mlp_plan(c["params_ref"])
    want_g = dict(ref_leaves(_ref_grads(c["cfg_ref"], c["params_ref"],
                                        c["batch_ref"], n_micro, ref_plan)))
    kw = dict(peak_lr=LR, warmup_steps=5, total_steps=10)
    ref_ocfg, ocfg = RefOptimizerConfig(**kw), OptimizerConfig(**kw)
    ref_step = jax.jit(ref_make_train_step(c["cfg_ref"], ref_ocfg, n_micro,
                                           mlp_plan=ref_plan))
    new_ref, _, ref_m = ref_step(c["params_ref"],
                                 ref_init_opt_state(ref_ocfg,
                                                    c["params_ref"]),
                                 c["batch_ref"])

    captured = []

    def capture(opt_cfg, params, grads, state):
        captured.append(tree_map(lambda t: t.clone(), grads))
        return apply_updates(opt_cfg, params, grads, state)

    monkeypatch.setattr(train_step_mod, "apply_updates", capture)
    params = _params(c)
    step = make_train_step(c["cfg"], ocfg, n_micro,
                           mlp_plan=_plan(c, params))
    params, _, m = step(params, init_opt_state(ocfg, params), c["batch"])

    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-4)
    got_g = port_leaves(stack_layers(captured[0]))
    assert set(got_g) == set(want_g)
    for path, g in got_g.items():
        w = want_g[path]
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-6, (path, err)
    lr = float(m["lr"])
    want_p = dict(ref_leaves(new_ref))
    for path, p in port_leaves(stack_layers(params)).items():
        assert float(np.abs(p - want_p[path]).max()) <= 2 * lr, path


def test_moe_step_runs_each_expert_product_forward_twice_and_backward_once(
        monkeypatch):
    """The count ``chip_smoke.py`` expects on the card, taken here by
    counting the calls into the wrappers: per layer and microbatch, with
    remat, 6 forward products (3, then 3 recomputed), 3 dx and 3 dW."""
    import sys
    mg = sys.modules["repro_torch.kernels.moe_gemm"]
    calls = {"forward": 0, "dx": 0, "dw": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(mg, "_forward", counting("forward", mg._forward))
    monkeypatch.setattr(mg, "moe_gemm_dx", counting("dx", mg.moe_gemm_dx))
    monkeypatch.setattr(mg, "moe_gemm_dw", counting("dw", mg.moe_gemm_dw))
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 9)).astype(np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    ocfg = OptimizerConfig(peak_lr=LR, warmup_steps=5, total_steps=10)
    for remat, forward in ((True, 6), (False, 3)):
        calls.update(forward=0, dx=0, dw=0)
        step = make_train_step(dataclasses.replace(cfg, remat=remat), ocfg, 2)
        step(params, init_opt_state(ocfg, params), batch)
        per = 2 * cfg.n_layers                 # microbatches × layers
        assert calls == {"forward": forward * per, "dx": 3 * per,
                         "dw": 3 * per}


@pytest.mark.parametrize("arch,extra", [
    ("whisper-base", []), ("internvl2-1b", ["--sparse-mlp"]),
    ("granite-moe-3b-a800m", ["--micro-batches", "2"]),
    ("mamba2-2.7b", [])])
def test_train_cli_runs_on_cpu(capsys, arch, extra):
    from repro_torch.launch.train import main
    run = main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                "--seq-len", "32", *extra])
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "step     2 loss=" in out
    assert len(run.history) == 3
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in run.history)
    cfg = run.cfg
    assert run.extra == ({"enc_frames": (4, cfg.enc_seq, cfg.d_model)}
                         if cfg.n_enc_layers else
                         {"vision_embeds": (4, cfg.n_patches, cfg.d_model)}
                         if cfg.n_patches else {})


def test_hybrid_training_still_raises():
    cfg = get_smoke_config("recurrentgemma-9b")
    params = lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
             "labels": torch.zeros((1, 4), dtype=torch.int64)}
    for fn in (lm.forward, lm.loss_fn):
        with pytest.raises(NotImplementedError, match="B9"):
            fn(params, cfg, batch)
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match="hybrid"):
        main(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
              "--steps", "1"])


def test_split_microbatches_splits_the_extra_inputs():
    batch = {"tokens": torch.arange(8).view(4, 2),
             "enc_frames": torch.arange(4 * 3 * 2.0).view(4, 3, 2),
             "vision_embeds": torch.arange(4 * 5.0).view(4, 5, 1)}
    parts = train_step_mod._split_microbatches(batch, 2)
    assert len(parts) == 2
    for i, mb in enumerate(parts):
        for k, v in batch.items():
            assert torch.equal(mb[k], v[2 * i:2 * i + 2])
