"""Port parity of the training slice: the data pipeline, the optimizer
and one train step of the qwen3-4b smoke config with a block-sparse MLP
(8×8 blocks), against ``repro`` on the CPU.

Tolerances: tokens and labels exactly equal; the learning rate and
AdamW on given arrays within 1e-6 (f32, one leaf at a time); the loss
within 1e-5 and every gradient leaf within 1e-4·max|ref| + 1e-6 (f32
sums in a different order through a whole model); parameters after one
step within 2·lr, because Adam's first step is sign-like and an element
whose gradient is near zero may move by ±lr in either package.
Parameters are initialised by the reference and carried across with
``repro_torch.convert`` into the trainer's per-layer layout.
"""

import dataclasses
import os

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
from repro.train import lr_at as ref_lr_at
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import merge_trainable, split_trainable
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.csr import BlockCSR
from repro_torch.data import DataConfig, synth_batch
from repro_torch.models import lm
from repro_torch.train import (OptimizerConfig, apply_updates,
                               init_opt_state, lr_at, make_train_step)
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.optimizer import _decayable, named_leaves, tree_map

LR = 3e-3


def flatten_ref(tree):
    """The reference pytree as nested dicts of numpy (BlockCSR → dict)."""
    if isinstance(tree, RefBlockCSR):
        return {"blocks": np.asarray(tree.blocks),
                "block_col": np.asarray(tree.block_col),
                "block_row": np.asarray(tree.block_row),
                "row_ptr": np.asarray(tree.row_ptr),
                "shape": tree.shape, "block_shape": tree.block_shape}
    if isinstance(tree, dict):
        return {k: flatten_ref(v) for k, v in tree.items()}
    return np.asarray(tree)


def ref_leaves(tree, prefix=""):
    """``(path, array)`` of the reference tree's float leaves, named as
    the port names its stacked tree (a payload as ``.../blocks``)."""
    if isinstance(tree, RefBlockCSR):
        yield f"{prefix}/blocks", np.asarray(tree.blocks)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from ref_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree)


def port_leaves(tree):
    return {k: v.detach().numpy() for k, v in named_leaves(tree)}


@pytest.mark.parametrize("b,s,seed,step", [(4, 64, 0, 0), (3, 17, 5, 7),
                                           (8, 256, 1, 123)])
def test_synth_batch_tokens_equal_reference(b, s, seed, step):
    want = ref_synth_batch(RefDataConfig(vocab_size=151_936, seq_len=s,
                                         global_batch=b, seed=seed), step)
    got = synth_batch(DataConfig(vocab_size=151_936, seq_len=s,
                                 global_batch=b, seed=seed), step)
    for k in ("tokens", "labels"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].dtype == torch.int32
    # extra inputs leave the tokens and labels as they were
    extra = synth_batch(DataConfig(vocab_size=151_936, seq_len=s,
                                   global_batch=b, seed=seed), step,
                        extra={"enc_frames": (b, 4, 8)})
    for k in ("tokens", "labels"):
        assert torch.equal(extra[k], got[k])
    assert tuple(extra["enc_frames"].shape) == (b, 4, 8)
    assert extra["enc_frames"].dtype == torch.float32


def test_lr_schedule_equals_reference():
    for kw in ({}, {"warmup_steps": 5, "total_steps": 10},
               {"warmup_steps": 0, "total_steps": 1}):
        ref_cfg, cfg = RefOptimizerConfig(**kw), OptimizerConfig(**kw)
        for step in (0, 1, 4, 5, 6, 50, 99, 100, 101, 5000, 10_000, 20_000):
            want = float(ref_lr_at(ref_cfg, jnp.asarray(step)))
            assert abs(float(lr_at(cfg, step)) - want) <= 1e-6 * max(
                abs(want), 1e-3)


def test_decay_choice_follows_the_path_tokens():
    params = lm.unstack_layers(lm.init_params(
        dataclasses.replace(get_smoke_config("qwen3-4b"), sparse_mlp=True,
                            sparse_block=(8, 8)),
        torch.Generator().manual_seed(0), device="cpu"))
    decayed = {k for k, _ in named_leaves(params) if _decayable(k)}
    assert "groups/b0/1/mlp/w_down/blocks" in decayed
    assert "embed_tokens" in decayed and "lm_head" in decayed
    assert not any("norm" in k for k in decayed)


@pytest.mark.parametrize("compress,scale,m_steps", [(False, 1.0, 1),
                                                    (False, 50.0, 3),
                                                    (True, 20.0, 2)])
def test_apply_updates_equals_reference_on_given_arrays(compress, scale,
                                                        m_steps):
    """Clipping (large grads), the decay exclusions, a sparse payload
    whose metadata is threaded through, and int8 compression with error
    feedback, over a few steps."""
    rng = np.random.default_rng(11)
    arr = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    meta = dict(block_col=np.array([0, 1, -1], np.int32),
                block_row=np.array([0, 1, 1], np.int32),
                row_ptr=np.array([0, 1, 2], np.int32))
    p_np = {"w": arr(6, 5), "norm1": {"scale": arr(5)}, "b_bias": arr(3),
            "w_down": arr(3, 4, 4)}
    ref_p = {k: jnp.asarray(v) for k, v in p_np.items() if k != "norm1"}
    ref_p["norm1"] = {"scale": jnp.asarray(p_np["norm1"]["scale"])}
    ref_p["w_down"] = RefBlockCSR(jnp.asarray(p_np["w_down"]),
                                  *(jnp.asarray(meta[k]) for k in
                                    ("block_col", "block_row", "row_ptr")),
                                  (8, 8), (4, 4))
    port_p = {"w": torch.tensor(p_np["w"]),
              "norm1": {"scale": torch.tensor(p_np["norm1"]["scale"])},
              "b_bias": torch.tensor(p_np["b_bias"]),
              "w_down": BlockCSR(torch.tensor(p_np["w_down"]), shape=(8, 8),
                                 block_shape=(4, 4), **meta)}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
              compress_grads=compress)
    ref_cfg, cfg = RefOptimizerConfig(**kw), OptimizerConfig(**kw)
    ref_state, state = ref_init_opt_state(ref_cfg, ref_p), \
        init_opt_state(cfg, port_p)
    for _ in range(m_steps):
        g_np = {"w": arr(6, 5) * scale, "scale": arr(5) * scale,
                "b_bias": arr(3) * scale, "w_down": arr(3, 4, 4) * scale}
        ref_g = {"w": jnp.asarray(g_np["w"]),
                 "norm1": {"scale": jnp.asarray(g_np["scale"])},
                 "b_bias": jnp.asarray(g_np["b_bias"]),
                 "w_down": RefBlockCSR(jnp.asarray(g_np["w_down"]),
                                       *(jnp.zeros(3, jnp.int32),) * 3,
                                       (8, 8), (4, 4))}
        grads = {"w": torch.tensor(g_np["w"]),
                 "norm1": {"scale": torch.tensor(g_np["scale"])},
                 "b_bias": torch.tensor(g_np["b_bias"]),
                 "w_down": dataclasses.replace(
                     port_p["w_down"], blocks=torch.tensor(g_np["w_down"]))}
        ref_p, ref_state, ref_m = ref_apply_updates(ref_cfg, ref_p, ref_g,
                                                    ref_state)
        port_p, state, m = apply_updates(cfg, port_p, grads, state)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)
        want = dict(ref_leaves(ref_p))
        for path, got in port_leaves(port_p).items():
            np.testing.assert_allclose(got, want[path], rtol=1e-6,
                                       atol=1e-6, err_msg=path)
    assert int(state.step) == m_steps
    assert port_p["w_down"].block_col.tolist() == [0, 1, -1]


# --------------------------------------------------------------------------
# the qwen3-4b smoke config with a sparse MLP: loss, grads, one step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    sparse = dict(sparse_mlp=True, sparse_block=(8, 8))
    cfg_ref = dataclasses.replace(ref_smoke_config("qwen3-4b"), **sparse)
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), **sparse)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                   global_batch=2), 0)
    batch_ref = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    return cfg_ref, cfg, params_ref, batch_ref, batch


def _port_params(cfg, params_ref):
    return lm.unstack_layers(params_from_numpy(flatten_ref(params_ref), cfg,
                                               device="cpu"))


def stack_layers(tree):
    """The trainer's per-layer lists (parameters or their gradients) back
    in the stacked layout, as the reference names its leaves."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        if isinstance(first, BlockCSR):
            return dataclasses.replace(
                first, blocks=torch.stack([it.blocks for it in items]),
                device_meta={})
        return torch.stack(items)

    return dict(tree, groups={name: stack(group)
                              for name, group in tree["groups"].items()})


def _ref_grads(cfg_ref, params_ref, batch_ref, n, plan):
    """Σ_mb ∇loss(mb) / n, the reference train step's accumulator."""
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
            g = [x / n for x in g]
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
        return acc

    _, rest, is_diff = aux
    zeros = [None if d else jnp.zeros_like(r) for d, r in zip(is_diff, rest)]
    return merge_trainable(grads(diff), (aux[0], zeros, is_diff))


def test_loss_equals_reference(smoke):
    cfg_ref, cfg, params_ref, batch_ref, batch = smoke
    ref_plan = ref_lm.sparse_mlp_plan(params_ref)
    want, want_aux = jax.jit(lambda p: ref_lm.loss_fn(
        p, cfg_ref, batch_ref, mlp_plan=ref_plan))(params_ref)
    params = _port_params(cfg, params_ref)
    plan = lm.sparse_mlp_plan(params)
    for remat in (True, False):
        got, aux = lm.loss_fn(params, cfg, batch, remat=remat, mlp_plan=plan)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        np.testing.assert_allclose(float(aux["z_loss"]),
                                   float(want_aux["z_loss"]), rtol=1e-5)
        assert int(aux["tokens"]) == int(want_aux["tokens"])
    with pytest.raises(TypeError, match="per-layer"):
        lm.loss_fn(stack_layers(params), cfg, batch, mlp_plan=plan)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_grads_and_params_match_reference(smoke, n_micro,
                                                     monkeypatch):
    cfg_ref, cfg, params_ref, batch_ref, batch = smoke
    ref_plan = ref_lm.sparse_mlp_plan(params_ref)
    want_g = dict(ref_leaves(_ref_grads(cfg_ref, params_ref, batch_ref,
                                        n_micro, ref_plan)))
    kw = dict(peak_lr=LR, warmup_steps=5, total_steps=10)
    ref_ocfg, ocfg = RefOptimizerConfig(**kw), OptimizerConfig(**kw)
    ref_step = jax.jit(ref_make_train_step(cfg_ref, ref_ocfg, n_micro,
                                           mlp_plan=ref_plan))
    new_ref, _, ref_m = ref_step(params_ref,
                                 ref_init_opt_state(ref_ocfg, params_ref),
                                 batch_ref)

    captured = []

    def capture(opt_cfg, params, grads, state):
        captured.append(tree_map(lambda t: t.clone(), grads))
        return apply_updates(opt_cfg, params, grads, state)

    monkeypatch.setattr(train_step_mod, "apply_updates", capture)
    params = _port_params(cfg, params_ref)
    step = make_train_step(cfg, ocfg, n_micro,
                           mlp_plan=lm.sparse_mlp_plan(params))
    params, state, m = step(params, init_opt_state(ocfg, params), batch)

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
    assert all(t.grad is None for _, t in named_leaves(params))


def test_remat_recomputes_each_sparse_layer_once(smoke, monkeypatch):
    """The count ``chip_smoke.py`` expects on the card, taken here by
    counting the calls into the kernels' wrappers: per layer and per
    microbatch, the planned kernel of the forward plan's layout runs for
    the forward and the remat recompute, the one of the transpose-side
    plan's layout for dB (rmw → ``maple_spmm_planned``, compact →
    ``maple_spmm_compact``), and the SDDMM once for dA."""
    from repro_torch.kernels import ops
    _, cfg, params_ref, _, batch = smoke
    names = {"rmw": "planned", "compact": "compact"}
    calls = {"planned": 0, "compact": 0, "sddmm": 0, "naive": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "maple_spmm_planned",
                        counting("planned", ops.maple_spmm_planned))
    monkeypatch.setattr(ops, "maple_spmm_compact",
                        counting("compact", ops.maple_spmm_compact))
    monkeypatch.setattr(ops, "maple_sddmm_bsr",
                        counting("sddmm", ops.maple_sddmm_bsr))
    monkeypatch.setattr(ops, "maple_spmm_naive",
                        counting("naive", ops.maple_spmm_naive))
    params = _port_params(cfg, params_ref)
    ocfg = OptimizerConfig(peak_lr=LR, warmup_steps=5, total_steps=10)
    plan = lm.sparse_mlp_plan(params)
    assert (plan.fwd.fused, plan.bwd.fused) == ("rmw", "rmw")
    for remat, per_layer in ((True, 3), (False, 2)):
        calls.update(planned=0, compact=0, sddmm=0, naive=0)
        step = make_train_step(dataclasses.replace(cfg, remat=remat), ocfg,
                               2, mlp_plan=plan)
        step(params, init_opt_state(ocfg, params), batch)
        want = {"planned": 0, "compact": 0, "sddmm": 2 * cfg.n_layers,
                "naive": 0}
        want[names[plan.fwd.fused]] += 2 * cfg.n_layers * (per_layer - 1)
        want[names[plan.bwd.fused]] += 2 * cfg.n_layers
        assert calls == want


def test_train_refuses_what_is_not_ported(smoke):
    """Two-level remat and a bf16 accumulator, refused before, are
    ported: the forward under two-level remat is the per-block one's bit
    for bit, and a step accumulating in bf16 runs."""
    _, cfg, params_ref, _, batch = smoke
    params = _port_params(cfg, params_ref)
    two = dataclasses.replace(cfg, scan_remat_chunk=2)
    assert cfg.n_layers % 2 == 0
    assert torch.equal(lm.forward(params, two, batch),
                       lm.forward(params, cfg, batch))
    # the partitioned (and autotuned partitioned) MLP plan is ported
    searched = lm.sparse_mlp_plan(params, autotune=True, n_shards=2)
    assert searched.fwd.n_block_rows == \
        lm.sparse_mlp_plan(params).fwd.n_block_rows
    assert lm.sparse_mlp_plan(params, n_shards=2).fwd.n_shards == 2
    ocfg = OptimizerConfig()
    bf16_acc = dataclasses.replace(cfg, grad_accum_dtype="bfloat16")
    step = make_train_step(bf16_acc, ocfg, 2,
                           mlp_plan=lm.sparse_mlp_plan(params))
    _, _, m = step(params, init_opt_state(ocfg, params), batch)
    assert np.isfinite(float(m["grad_norm"]))
    dense = lm.init_params(get_smoke_config("qwen3-4b"),
                           torch.Generator().manual_seed(0), device="cpu")
    assert lm.sparse_mlp_plan(dense) is None


@pytest.mark.parametrize("extra", [[], ["--sparse-mlp", "--micro-batches",
                                        "2"]])
def test_train_cli_runs_on_cpu(capsys, extra, tmp_path):
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.launch.train import main
    run = main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                "--steps", "3", *extra])
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "step     2 loss=" in out
    assert len(run.history) == 3
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in run.history)
    assert run.cfg.sparse_mlp == bool(extra)
    # --ckpt-dir / --ckpt-every: a save every 2 steps and at the last,
    # then a resume that runs only the steps still to go
    flags = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", *extra]
    main([*flags, "--steps", "3"])
    out = capsys.readouterr().out
    assert out.count("checkpointed → ") == 2 and "resumed" not in out
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    resumed = main([*flags, "--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step     3 loss=" in out
    assert [r["step"] for r in resumed.history] == [3]
    assert int(resumed.opt.step) == 4
