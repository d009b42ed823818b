"""Port parity of training every family but the dense one
(``test_torch_train``): the smoke configs of whisper-base (encoder,
cross-attention, layer norms, GELU MLPs), internvl2-1b (the vision
prefix; dense, and with a block-sparse MLP at (8, 8) blocks),
granite-moe-3b-a800m (expert products on B8's forward and backward),
mamba2-2.7b (the SSD scan through autograd), recurrentgemma-9b (the
RG-LRU scan through autograd, local attention on ``chunked_attention``
over a sequence of 48 against its window of 16; dense, and sparse at
(8, 8)), qwen2-72b (QKV biases) and qwen3-moe-235b-a22b (two-level
remat over its 2 layers, and at 2 microbatches its bf16 gradient
accumulator), against ``repro`` on the CPU.

Parameters are initialised by the reference (biases drawn non-zero) and
carried across with ``repro_torch.convert`` into the trainer's per-layer
layout.  One batch, built with numpy (tokens, labels and the encoder
frames or patch embeddings), goes to both packages, since the two
``synth_batch``es draw the extra inputs differently.

Tolerances, as ``test_torch_train``'s: the loss within 1e-5 relative;
every gradient leaf within 1e-4·max|ref| + 1e-6 (f32 sums in another
order through a whole model); the parameters after one AdamW step within
2·lr (Adam's first step is sign-like).  Where the config accumulates
microbatch gradients in bf16 (qwen3-moe-235b-a22b at 2 microbatches),
both packages round each microbatch's gradient and each sum to bf16, and
a value near a rounding boundary may land one bf16 step (2^-8 relative)
apart: those gradients are held within 1e-2·max|ref|.  Remat on and off,
and two-level remat against per-block remat, give the same loss and
gradients within 1e-6 relative.
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
from repro.train.train_step import merge_trainable, split_trainable
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
         "mamba2": ("mamba2-2.7b", {}, 64),       # two SSD chunks of 32
         "hybrid": ("recurrentgemma-9b", {}, 48),  # three windows of 16
         "hybrid_sparse": ("recurrentgemma-9b",
                           dict(sparse_mlp=True, sparse_block=(8, 8)), 48),
         "qwen2_72b": ("qwen2-72b", {}, 16),
         "qwen3_moe": ("qwen3-moe-235b-a22b", {}, 16)}
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


def _ref_grads_in(acc_dt, cfg_ref, params_ref, batch_ref, n, plan):
    """The reference train step's accumulated gradients: Σ_mb ∇loss(mb) / n
    in f32 (``test_torch_train._ref_grads``), or, for a bf16 accumulator,
    ``acc + ∇loss(mb).astype(bf16) / n`` as its ``make_train_step`` sums
    them, returned as f32."""
    if acc_dt == "float32":
        return _ref_grads(cfg_ref, params_ref, batch_ref, n, plan)
    dt = jnp.dtype(acc_dt)
    diff, aux = split_trainable(params_ref)

    @jax.jit
    def grads(diff):
        acc = None
        for i in range(n):
            mb = {k: v.reshape(n, -1, *v.shape[1:])[i]
                  for k, v in batch_ref.items()}
            g = jax.grad(lambda d: ref_lm.loss_fn(
                merge_trainable(d, aux), cfg_ref, mb, remat=True,
                mlp_plan=plan)[0])(diff)
            g = [x.astype(dt) / n for x in g]
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
        return [a.astype(jnp.float32) for a in acc]

    _, rest, is_diff = aux
    zeros = [None if d else jnp.zeros_like(r) for d, r in zip(is_diff, rest)]
    return merge_trainable(grads(diff), (aux[0], zeros, is_diff))


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
    acc_dt = c["cfg"].grad_accum_dtype if n_micro > 1 else "float32"
    want_g = dict(ref_leaves(_ref_grads_in(acc_dt, c["cfg_ref"],
                                           c["params_ref"], c["batch_ref"],
                                           n_micro, ref_plan)))
    rel = 1e-4 if acc_dt == "float32" else 1e-2
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
    assert all(t.dtype == getattr(torch, acc_dt)
               for _, t in named_leaves(captured[0]))
    got_g = port_leaves(stack_layers(tree_map(lambda t: t.float(),
                                              captured[0])))
    assert set(got_g) == set(want_g)
    for path, g in got_g.items():
        w = want_g[path]
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()) + 1e-6, (path, err)
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
    ("mamba2-2.7b", []), ("recurrentgemma-9b", []),
    ("qwen3-moe-235b-a22b", ["--micro-batches", "2"])])
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


def test_hybrid_training_still_raises(monkeypatch):
    """The hybrid family trains (it raised before its local attention had
    a backward): its forward under a gradient makes no B9 call (the
    kernel raises under one) and takes ``chunked_attention`` once a
    local-attention layer."""
    cfg = get_smoke_config("recurrentgemma-9b")
    params = lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 41)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    import repro_torch.models.layers as layers
    calls = []
    real = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention",
                        lambda *a, **kw: calls.append(a[3:]) or real(*a,
                                                                     **kw))
    monkeypatch.setattr(layers.ops, "local_block_attention", None)
    loss, _ = lm.loss_fn(params, cfg, batch, remat=False)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    n_local = sum(k == "local_attn" for k in cfg.block_kinds())
    assert calls == [(True, cfg.window)] * n_local
    assert all(t.grad is not None for _, t in named_leaves(params))


@pytest.mark.parametrize("arch,chunk", [("qwen3-moe-235b-a22b", 2),
                                        ("recurrentgemma-9b", 2)])
def test_two_level_remat_equals_per_block_and_no_remat(arch, chunk,
                                                       monkeypatch):
    """``scan_remat_chunk`` = 2 over qwen3-moe-235b's 2 layers (one run of
    2 groups) and over recurrentgemma's tail of 2 (its 1 group stays per
    block): the loss and every gradient equal per-block remat's and no
    remat's within 1e-6 relative.  Under two-level remat a block
    runs its forward three times (the forward, the outer recompute, its
    own recompute), but the last group of a run only twice: the outer
    recompute stops once it holds that group's input (non-reentrant
    checkpoints stop early); under per-block remat twice, without remat
    once."""
    cfg = dataclasses.replace(get_smoke_config(arch), scan_remat_chunk=chunk)
    stacked = lm.init_params(cfg, torch.Generator().manual_seed(2),
                             device="cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 25)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    calls = []
    real = lm._apply_block
    monkeypatch.setattr(lm, "_apply_block",
                        lambda p, c, kind, *a: calls.append(kind) or
                        real(p, c, kind, *a))
    _, n_groups, tail = cfg.layer_plan()
    two = len(tail) if arch == "recurrentgemma-9b" else cfg.n_layers
    runs = {}
    for name, over, remat in (("two_level", {}, True),
                              ("per_block", dict(scan_remat_chunk=0), True),
                              ("none", {}, False)):
        params = lm.unstack_layers(tree_map(lambda t: t.clone(), stacked))
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        calls.clear()
        loss, _ = lm.loss_fn(params, dataclasses.replace(cfg, **over), batch,
                             remat=remat)
        loss.backward()
        runs[name] = (float(loss.detach()),
                      {k: t.grad for k, t in named_leaves(params)})
        per = {"two_level": 2, "per_block": 2, "none": 1}[name]
        # two-level: one more forward a block of every run's groups but
        # its last (one run of `chunk` layers here)
        want = per * cfg.n_layers + (two - two // chunk
                                     if name == "two_level" else 0)
        assert len(calls) == want, (name, len(calls))
    loss, grads = runs["two_level"]
    for name in ("per_block", "none"):
        np.testing.assert_allclose(runs[name][0], loss, rtol=1e-6)
        for k, g in grads.items():
            other = runs[name][1][k]
            assert float((g - other).abs().max()) <= \
                1e-6 * float(other.abs().max()) + 1e-7, (name, k)


# --------------------------------------------------------------------------
# the RG-LRU's gradients through its scan
# --------------------------------------------------------------------------

def test_rglru_gradients_match_jax_grad():
    """The RG-LRU block's gradients (its Hillis–Steele scan through
    autograd) against ``jax.grad`` of the reference's ``rglru_block``, in
    x and every parameter, with some channels' Λ pushed to -30, where
    a = 1 in f32 and ``sqrt(clamp(1 - a², 1e-9))`` sits on its clamp;
    and of ``rg_lru_scan`` alone in both of its inputs.  Within
    1e-5·max|ref| + 1e-6."""
    from repro.models import rglru as RR
    from repro_torch.models import rglru as R
    d, w, s = 16, 24, 37
    ref = RR.init_rglru(jax.random.PRNGKey(4), RR.RGLRUConfig(d, w))
    lam = np.array(ref["lambda"])
    lam[::5] = -30.0                                 # a == 1: the clamp
    ref = dict(ref, **{"lambda": jnp.asarray(lam)})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    dy = rng.standard_normal((2, s, d)).astype(np.float32)
    cfg_r, cfg = RR.RGLRUConfig(d, w), R.RGLRUConfig(d, w)
    la, _ = R._rg_lru_gates({k: torch.from_numpy(np.array(v))
                             for k, v in ref.items()}, cfg,
                            torch.from_numpy(x[..., :1].repeat(w, -1)))
    assert bool((la[..., ::5] == 0).all() | (la[..., ::5] > -1e-9).all())

    want_x, want_p = jax.grad(lambda x, p: jnp.sum(
        RR.rglru_block(p, cfg_r, x) * dy), argnums=(0, 1))(jnp.asarray(x),
                                                            ref)
    pt = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in ref.items()}
    xt = torch.from_numpy(x).requires_grad_()
    (R.rglru_block(pt, cfg, xt) * torch.from_numpy(dy)).sum().backward()

    def close(g, want, what):
        want = np.asarray(want)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()) + 1e-6, (what, err)

    close(xt.grad, want_x, "x")
    for k in ref:
        close(pt[k].grad, want_p[k], k)
    assert float(pt["lambda"].grad[::5].abs().max()) < \
        1e-3 * float(pt["lambda"].grad.abs().max())

    log_a = -rng.uniform(0.0, 0.5, (2, s, w)).astype(np.float32)
    gated = rng.standard_normal((2, s, w)).astype(np.float32)
    dh = rng.standard_normal((2, s, w)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(RR.rg_lru_scan(a, b) * dh),
                    argnums=(0, 1))(jnp.asarray(log_a), jnp.asarray(gated))
    ta, tb = (torch.from_numpy(t).requires_grad_() for t in (log_a, gated))
    (R.rg_lru_scan(ta, tb) * torch.from_numpy(dh)).sum().backward()
    close(ta.grad, want[0], "log_a")
    close(tb.grad, want[1], "gated")


# --------------------------------------------------------------------------
# bf16 parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_micro", [("qwen2-72b", 1),
                                          ("qwen2-72b", 2)])
def test_bf16_parameters_train_as_the_reference(arch, n_micro, monkeypatch):
    """One train step on bf16 parameters (the reference's ``init_params``
    at bf16: every weight bf16, the norms f32) against the reference's
    step on the same parameters, qwen2-72b's smoke config at 1 and (its
    bf16 accumulator) 2 microbatches.  bf16 tolerance: the loss within
    1e-2 relative; every gradient (bf16) within 5e-2·max|ref| + 1e-6:
    both packages round the activations and each product to bf16 (2^-8
    relative), XLA once a fused chain of elementwise ops and torch after
    each op, and over the model's two layers the gradients land up to
    about 7 bf16 steps (2.6 %) apart; every parameter after the step
    within 2·lr plus one bf16 step of its size (Adam's first step is
    sign-like, and the update is rounded back to bf16).  A MoE config is
    left out: in bf16 the two packages' router logits tie differently and
    route some tokens to other experts."""
    cfg_ref, cfg, _, _ = models(arch, 3)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(6),
                                    dtype=jnp.bfloat16)
    dtypes = {p: np.asarray(v).dtype for p, v in ref_leaves(params_ref)}
    f32 = jax.tree_util.tree_map(lambda v: v.astype(jnp.float32)
                                 if v.dtype == jnp.bfloat16 else v,
                                 params_ref)
    from test_torch_serve import flatten_ref
    from repro_torch.convert import params_from_numpy
    stacked = params_from_numpy(flatten_ref(f32), cfg, device="cpu")
    paths = iter([p for p, _ in named_leaves(stacked)])
    stacked = tree_map(lambda t: t.to(torch.bfloat16)
                       if dtypes[next(paths)] != np.float32 else t, stacked)
    assert {t.dtype for _, t in named_leaves(stacked)} == \
        {torch.bfloat16, torch.float32}
    rng = np.random.default_rng(8)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, 17)).astype(np.int32)
    batch_np = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    batch_ref = {k: jnp.asarray(v) for k, v in batch_np.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    kw = dict(peak_lr=LR, warmup_steps=5, total_steps=10)
    ref_ocfg, ocfg = RefOptimizerConfig(**kw), OptimizerConfig(**kw)
    acc_dt = cfg.grad_accum_dtype if n_micro > 1 else None
    want_g = dict(ref_leaves(_ref_grads_in(
        "float32" if acc_dt is None else acc_dt, cfg_ref, params_ref,
        batch_ref, n_micro, None)))
    new_ref, _, ref_m = jax.jit(ref_make_train_step(cfg_ref, ref_ocfg,
                                                    n_micro))(
        params_ref, ref_init_opt_state(ref_ocfg, params_ref), batch_ref)

    captured = []

    def capture(opt_cfg, params, grads, state):
        captured.append(tree_map(lambda t: t.clone(), grads))
        return apply_updates(opt_cfg, params, grads, state)

    monkeypatch.setattr(train_step_mod, "apply_updates", capture)
    params = lm.unstack_layers(stacked)
    step = make_train_step(cfg, ocfg, n_micro)
    params, _, m = step(params, init_opt_state(ocfg, params), batch)

    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-2)
    grads = stack_layers(captured[0])
    for path, g in named_leaves(grads):
        want_dt = torch.bfloat16 if acc_dt else \
            getattr(torch, str(dtypes[path]))
        assert g.dtype == want_dt, path
        w = np.asarray(want_g[path], np.float32)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= 5e-2 * float(np.abs(w).max()) + 1e-6, (path, err)
    lr = float(m["lr"])
    want_p = {p: np.asarray(v, np.float32) for p, v in ref_leaves(new_ref)}
    for path, p in named_leaves(stack_layers(params)):
        assert p.dtype == getattr(torch, str(dtypes[path])), path
        got = p.detach().float().numpy()
        ulp = 2.0 ** -7 * float(np.abs(want_p[path]).max())
        assert float(np.abs(got - want_p[path]).max()) <= 2 * lr + ulp, path


def test_split_microbatches_splits_the_extra_inputs():
    batch = {"tokens": torch.arange(8).view(4, 2),
             "enc_frames": torch.arange(4 * 3 * 2.0).view(4, 3, 2),
             "vision_embeds": torch.arange(4 * 5.0).view(4, 5, 1)}
    parts = train_step_mod._split_microbatches(batch, 2)
    assert len(parts) == 2
    for i, mb in enumerate(parts):
        for k, v in batch.items():
            assert torch.equal(mb[k], v[2 * i:2 * i + 2])
