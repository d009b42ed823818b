"""Port parity of the global-attention configs the port adds (minitron-8b,
qwen2-7b, qwen2-72b, qwen3-moe-235b-a22b), of ``configs/base.py``'s shape
grid, and of the QKV-bias models, against ``repro`` on the CPU.

Configs are held field for field (``config()`` and ``smoke_config()``),
with ``param_count``, ``SHAPES``, ``shape_applicable`` and
``input_specs`` (meta tensors against the reference's
``jax.ShapeDtypeStruct``: same shapes, the torch counterpart of each
dtype).  Models run on the smoke configs with weights initialised by the
reference and carried across with ``repro_torch.convert``; the QKV
biases, which the reference initialises to zeros, are first set to
random non-zero values, so a test passes only if both packages add them.
Logits within 1e-4 (the repo's f32 tolerance), greedy tokens equal; the
train step as in ``test_torch_train``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.serve import paged_cache as ref_pc
from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train import apply_updates as ref_apply_updates
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm
from repro_torch.serve import SamplingConfig, generate, paged_cache
from repro_torch.train import (OptimizerConfig, apply_updates,
                               init_opt_state, make_train_step)
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.optimizer import named_leaves, tree_map
from test_torch_serve import flatten_ref
from test_torch_train import _ref_grads, port_leaves, ref_leaves, stack_layers

TOL = dict(rtol=1e-4, atol=1e-4)
NEW = ("minitron-8b", "qwen2-7b", "qwen2-72b", "qwen3-moe-235b-a22b")
DENSE = ("minitron-8b", "qwen2-7b", "qwen2-72b")
FULL = {  # (n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab, qkv_bias)
    "minitron-8b": (32, 4096, 32, 8, 16384, 256_000, False),
    "qwen2-7b": (28, 3584, 28, 4, 18944, 152_064, True),
    "qwen2-72b": (80, 8192, 64, 8, 29568, 152_064, True),
    "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 151_936, False),
}


# --------------------------------------------------------------------------
# configs and the shape grid
# --------------------------------------------------------------------------

def test_registry_uses_the_reference_names():
    assert set(NEW) <= set(configs.ARCHS)
    assert set(configs.ARCHS) <= set(ref_configs.ARCHS)
    for name in ("SHAPES", "ShapeSpec", "input_specs", "shape_applicable"):
        assert name in configs.__all__ and hasattr(configs, name)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_config_fields_equal_reference(arch, smoke):
    get, ref_get = ((configs.get_smoke_config, ref_configs.get_smoke_config)
                    if smoke else (configs.get_config,
                                   ref_configs.get_config))
    mine, ref = get(arch), ref_get(arch)
    for field in dataclasses.fields(mine):
        assert getattr(mine, field.name) == getattr(ref, field.name), \
            field.name
    assert mine.vocab_padded == ref.vocab_padded
    assert mine.ffn_kind == ref.ffn_kind
    assert mine.block_kinds() == ref.block_kinds()
    for active in (False, True):
        assert mine.param_count(active) == ref.param_count(active)


@pytest.mark.parametrize("arch", NEW)
def test_full_configs_are_the_published_ones(arch):
    c = configs.get_config(arch)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab_size, c.qkv_bias) == FULL[arch]
    giant = arch in ("qwen2-72b", "qwen3-moe-235b-a22b")
    assert c.bf16_first_moment == giant
    assert (c.scan_remat_chunk > 1) == giant


def test_shapes_equal_reference():
    assert list(configs.SHAPES) == list(ref_configs.SHAPES)
    for name, s in configs.SHAPES.items():
        assert dataclasses.astuple(s) == \
            dataclasses.astuple(ref_configs.SHAPES[name])
    for arch in configs.ARCHS:
        for s, ref_s in zip(configs.SHAPES.values(),
                            ref_configs.SHAPES.values()):
            assert configs.shape_applicable(configs.get_config(arch), s) == \
                ref_configs.shape_applicable(ref_configs.get_config(arch),
                                             ref_s)
    hybrid = dataclasses.replace(configs.get_config("qwen3-4b"),
                                 family="hybrid")
    assert configs.shape_applicable(hybrid,
                                    configs.SHAPES["long_500k"]) == (True, "")


DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("extra", [{}, {"n_patches": 16},
                                   {"n_enc_layers": 2, "enc_seq": 24}])
@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-moe-235b-a22b"])
def test_input_specs_match_reference(arch, extra):
    cfg = dataclasses.replace(configs.get_config(arch), **extra)
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch), **extra)
    for (name, s), ref_s in zip(configs.SHAPES.items(),
                                ref_configs.SHAPES.values()):
        for dt, ref_dt in ((torch.bfloat16, jnp.bfloat16),
                           (torch.float32, jnp.float32)):
            got = configs.input_specs(cfg, s, dtype=dt)
            want = ref_configs.input_specs(ref_cfg, ref_s, dtype=ref_dt)
            assert list(got) == list(want), name
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[k].shape, (name, k)
                assert t.dtype == DTYPES[jnp.dtype(want[k].dtype)], (name, k)
    assert configs.input_specs(cfg, configs.SHAPES["train_4k"])[
        "tokens"].dtype == torch.int32


# --------------------------------------------------------------------------
# the models on the smoke configs
# --------------------------------------------------------------------------

def _with_random_biases(params_ref, cfg, seed):
    """The reference tree with non-zero QKV biases (it initialises them
    to zeros)."""
    if not cfg.qkv_bias:
        return params_ref
    attn = dict(params_ref["groups"]["b0"]["attn"])
    assert not any(np.asarray(attn[k]).any() for k in ("bq", "bk", "bv"))
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv"):
        attn[k] = jnp.asarray(rng.standard_normal(attn[k].shape)
                              .astype(np.float32) * 0.5)
    block = dict(params_ref["groups"]["b0"], attn=attn)
    return dict(params_ref, groups={"b0": block})


@functools.cache
def _models(arch):
    """Both packages' smoke config and parameters (the reference's init,
    biases made non-zero, carried across), once per arch."""
    cfg_ref = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    params_ref = _with_random_biases(
        ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0)), cfg, 5)
    params = params_from_numpy(flatten_ref(params_ref), cfg, device="cpu")
    return cfg_ref, cfg, params_ref, params


@pytest.mark.parametrize("arch", NEW)
def test_converter_carries_every_leaf(arch):
    cfg_ref, cfg, params_ref, params = _models(arch)
    want = dict(ref_leaves(params_ref))
    got = port_leaves(params)
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.array_equal(got[path], w), path
    attn = params["groups"]["b0"]["attn"]
    if cfg.qkv_bias:
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        assert attn["bq"].shape == (cfg.n_layers, h, hd)
        assert attn["bk"].shape == attn["bv"].shape == (cfg.n_layers, kvh, hd)
        per_layer = lm.unstack_layers(params)["groups"]["b0"]
        for i, layer in enumerate(per_layer):
            for k in ("bq", "bk", "bv"):
                assert torch.equal(layer["attn"][k], attn[k][i])
    else:
        assert not {"bq", "bk", "bv"} & set(attn)
    port = lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else
                        tuple(v.shape) for k, v in t.items()}
    assert shapes(port) == shapes(params)
    if cfg.qkv_bias:
        assert not port["groups"]["b0"]["attn"]["bq"].any()


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_reference(arch):
    cfg_ref, cfg, params_ref, params = _models(arch)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    max_seq = 9 + 3
    ref_logits, ref_state = ref_engine.jitted_prefill(cfg_ref, max_seq)(
        params_ref, batch={"tokens": jnp.asarray(prompts, jnp.int32)})
    logits, state = lm.prefill(params, cfg,
                               {"tokens": torch.from_numpy(prompts)},
                               max_seq=max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    step_ref = ref_engine.jitted_decode_step(cfg_ref)
    forced = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 3))
    for t in range(3):
        tok = forced[:, t:t + 1]
        ref_logits, ref_state = step_ref(params_ref, state=ref_state,
                                         tokens=jnp.asarray(tok, jnp.int32))
        logits, state = lm.decode_step(params, cfg, state,
                                       torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   err_msg=f"decode step {t}", **TOL)


@pytest.mark.parametrize("arch", NEW)
def test_greedy_tokens_match_reference(arch):
    cfg_ref, cfg, params_ref, params = _models(arch)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 7))
    ref_tokens, ref_ent = ref_engine.generate(
        params_ref, cfg_ref, {"tokens": jnp.asarray(prompts, jnp.int32)},
        ref_engine.SamplingConfig(max_new_tokens=6))
    tokens, ent = generate(params, cfg, {"tokens": torch.from_numpy(prompts)},
                           SamplingConfig(max_new_tokens=6))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_allclose(ent, ref_ent, **TOL)


def test_the_biases_change_the_logits():
    """qwen2-7b smoke: zeroing the (random) biases moves the logits, so
    the parity above holds with the biases in play."""
    _, cfg, _, params = _models("qwen2-7b")
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 6)))}
    attn = params["groups"]["b0"]["attn"]
    zeroed = dict(params, groups={"b0": dict(
        params["groups"]["b0"], attn=dict(
            attn, **{k: torch.zeros_like(attn[k])
                     for k in ("bq", "bk", "bv")}))})
    with_b, _ = lm.prefill(params, cfg, tokens)
    without, _ = lm.prefill(zeroed, cfg, tokens)
    assert float((with_b - without).abs().max()) > 1e-2


@pytest.mark.timeout(240)
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_paged_matches_reference(arch):
    """Three requests prefilled by each package into their pages, a free
    fourth slot, then three teacher-forced fused steps: logits within
    1e-4 at every step."""
    cfg_ref, cfg, params_ref, params = _models(arch)
    psize, n_pages, max_pages = 4, 12, 3
    lens = (5, 7, 3)
    slot_pages = ([3, 9, 1], [7, 2, 11], [8, 10, 4])
    state_ref = ref_lm.init_paged_state(cfg_ref, 4, n_pages, psize,
                                        max_pages)
    state = lm.init_paged_state(cfg, 4, n_pages, psize, max_pages,
                                device="cpu")
    rng = np.random.default_rng(9)
    for slot, (n, pages) in enumerate(zip(lens, slot_pages)):
        prompt = rng.integers(0, cfg.vocab_size, (1, n))
        held = pages[:-(-n // psize)]
        max_seq = len(held) * psize
        _, pre_ref = ref_engine.jitted_prefill(cfg_ref, max_seq)(
            params_ref, batch={"tokens": jnp.asarray(prompt, jnp.int32)})
        state_ref = ref_pc.scatter_prefill_state(state_ref, pre_ref, slot,
                                                 held, psize)
        _, pre = lm.prefill(params, cfg, {"tokens": torch.from_numpy(
            prompt)}, max_seq=max_seq)
        paged_cache.scatter_prefill_state(state, pre, slot, held, psize)
    table = ref_pc.make_table(list(slot_pages) + [[]], max_pages)
    pos = np.array(list(lens) + [0], np.int32)
    state_ref = dict(state_ref, table=jnp.asarray(table),
                     pos=jnp.asarray(pos))
    state = dict(state, table=torch.from_numpy(table),
                 pos=torch.from_numpy(pos))
    step_ref = ref_engine.jitted_decode_step(cfg_ref, paged=True)
    for t in range(3):
        tok = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
        tok[3] = 0                                      # the free slot
        want, state_ref = step_ref(params_ref, state=state_ref,
                                   tokens=jnp.asarray(tok))
        got, state = lm.decode_step_paged(params, cfg, state,
                                          torch.from_numpy(tok))
        np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3],
                                   err_msg=f"fused step {t}", **TOL)


# --------------------------------------------------------------------------
# training: qwen2-7b (QKV biases) trains; the giant configs stay refused
# --------------------------------------------------------------------------

LR = 3e-3


def test_qwen2_train_step_matches_reference(monkeypatch):
    cfg_ref, cfg, params_ref, _ = _models("qwen2-7b")
    from repro_torch.data import DataConfig, synth_batch
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                   global_batch=2), 0)
    batch_ref = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want_loss, _ = jax.jit(lambda p: ref_lm.loss_fn(p, cfg_ref, batch_ref))(
        params_ref)
    # a copy of its own: the step updates the shared leaves in place
    params = lm.unstack_layers(params_from_numpy(flatten_ref(params_ref),
                                                 cfg, device="cpu"))
    got_loss, _ = lm.loss_fn(params, cfg, batch)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)

    want_g = dict(ref_leaves(_ref_grads(cfg_ref, params_ref, batch_ref, 1,
                                        None)))
    kw = dict(peak_lr=LR, warmup_steps=5, total_steps=10)
    ref_ocfg, ocfg = RefOptimizerConfig(**kw), OptimizerConfig(**kw)
    new_ref, _, ref_m = jax.jit(ref_make_train_step(cfg_ref, ref_ocfg, 1))(
        params_ref, ref_init_opt_state(ref_ocfg, params_ref), batch_ref)
    captured = []

    def capture(opt_cfg, p, grads, state):
        captured.append(tree_map(lambda t: t.clone(), grads))
        return apply_updates(opt_cfg, p, grads, state)

    monkeypatch.setattr(train_step_mod, "apply_updates", capture)
    step = make_train_step(cfg, ocfg, 1)
    before = {k: v.copy() for k, v in port_leaves(stack_layers(params))
              .items()}
    params, _, m = step(params, init_opt_state(ocfg, params), batch)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
    got_g = port_leaves(stack_layers(captured[0]))
    assert set(got_g) == set(want_g)
    assert {"groups/b0/attn/bq", "groups/b0/attn/bk",
            "groups/b0/attn/bv"} <= set(got_g)
    for path, g in got_g.items():
        w = want_g[path]
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-6, (path, err)
    assert float(np.abs(got_g["groups/b0/attn/bv"]).max()) > 0
    # each leaf's update (new - old) against the reference optimizer's
    # update from the same gradients, at the gradients' f32 limit.  (Adam's
    # first step moves each entry by about lr·g/(|g| + eps): where a
    # gradient is f32 noise of order eps, as some of bk's are, two
    # gradients within the limit above give updates that differ by a
    # sizeable share of lr, so the reference's own step is held only
    # through its gradients.)
    grads_tree = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(got_g["/".join(k.key for k in path)]),
        params_ref)
    from_same, _, _ = ref_apply_updates(
        ref_ocfg, params_ref, grads_tree,
        ref_init_opt_state(ref_ocfg, params_ref))
    old_ref, want_p = dict(ref_leaves(params_ref)), dict(ref_leaves(from_same))
    got_p = port_leaves(stack_layers(params))
    assert set(got_p) == set(want_p)
    for path, p in got_p.items():
        got_u = p - before[path]
        want_u = want_p[path] - old_ref[path]
        err = float(np.abs(got_u - want_u).max())
        assert err <= 1e-4 * float(np.abs(want_u).max()) + 1e-6, (path, err)
        assert float(np.abs(want_u).max()) > 0, path
    # and the whole step against the reference's own, each entry within
    # Adam's first-step reach of it
    lr = float(m["lr"])
    for path, p in dict(ref_leaves(new_ref)).items():
        assert float(np.abs(got_p[path] - p).max()) <= 2 * lr, path
    assert all(t.grad is None for _, t in named_leaves(params))


@pytest.mark.parametrize("arch", ["qwen2-72b", "qwen3-moe-235b-a22b"])
def test_giant_configs_serve_but_do_not_train(arch):
    """The giant configs keep two-level remat and the bf16 accumulator in
    their smoke configs, and train now (they raised before): the loss
    equals the reference's, and a train step at 2 microbatches runs
    (``test_torch_train_families`` holds its gradients)."""
    cfg_ref, cfg, params_ref, params = _models(arch)
    assert cfg.scan_remat_chunk > 1 and cfg.grad_accum_dtype == "bfloat16"
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    want, _ = jax.jit(lambda p: ref_lm.loss_fn(p, cfg_ref, {
        k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}))(
        params_ref)
    params = lm.unstack_layers(params)
    got, _ = lm.loss_fn(params, cfg, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    ocfg = OptimizerConfig()
    step = make_train_step(cfg, ocfg, 2)
    _, _, m = step(params, init_opt_state(ocfg, params), batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
