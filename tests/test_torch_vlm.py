"""Port parity: the vision-prefix family (internvl2-1b) against ``repro``
on the CPU.

The smoke config, dense and with a block-sparse MLP at (8, 8) (its
down-projection on B3's plain version here), initialised by the reference
with its QKV biases drawn non-zero and carried across with
``repro_torch.convert``: ``_embed_inputs`` within 1e-5; ``prefill`` and
``decode_step`` logits and caches within 1e-4, and equal greedy tokens,
through ``generate`` and through the sparse head; ``generate`` sizes its
cache with the vision prefix (text + n_patches + max_new).  Also the
extra inputs of ``data.synth_batch``, the serve CLI, the converter's
``vis_proj``, and what stays refused: a vision prefix outside the vlm
family, training it, paged decode and ``complete_static``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import DataConfig as RefDataConfig
from repro.data import synth_batch as ref_synth_batch
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, synth_batch
from repro_torch.kernels import maple_spmm_naive
from repro_torch.models import lm
from repro_torch.serve import SamplingConfig, complete_static, generate
from test_torch_encdec import (LOGITS, batches, check_generate,
                               check_head_route, check_serving, extras,
                               models)
from test_torch_serve import flatten_ref

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "internvl2-1b"
SPARSE = dict(sparse_mlp=True, sparse_block=(8, 8))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_config_fields_and_param_count_equal_reference(getter):
    get, ref_get = ((configs.get_config, ref_configs.get_config)
                    if getter == "full" else
                    (configs.get_smoke_config, ref_configs.get_smoke_config))
    port, ref = get(ARCH), ref_get(ARCH)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.layer_plan() == ref.layer_plan()
    assert port.vocab_padded == ref.vocab_padded
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active)
    for s, ref_s in zip(configs.SHAPES.values(),
                        ref_configs.SHAPES.values()):
        assert configs.shape_applicable(port, s) == \
            ref_configs.shape_applicable(ref, ref_s)
    assert lm.needs_kv_pages(port) == ref_lm.needs_kv_pages(ref)
    assert lm.history_horizon(port) == ref_lm.history_horizon(ref)


def test_full_config_is_the_published_one():
    c = configs.get_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.n_patches, c.vocab_size, c.vocab_padded, c.qkv_bias,
            c.rope_theta) == (24, 896, 14, 2, 64, 4864, 256, 151_655,
                              153_600, True, 1e6)
    assert c.param_count() == 633_077_760
    assert ARCH in configs.ARCHS


# --------------------------------------------------------------------------
# the smoke model, dense and with a sparse MLP
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["dense", "sparse_mlp"])
def model(request):
    return models(ARCH, 10, **(SPARSE if request.param == "sparse_mlp"
                               else {}))


def test_embed_inputs_matches_reference(model):
    cfg_ref, cfg, params_ref, params = model
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5))
    ref_b, port_b = batches(tok, extras(cfg, 2, 0))
    wx, wpos = ref_lm._embed_inputs(params_ref, cfg_ref, ref_b)
    x, pos = lm._embed_inputs(params, cfg, port_b)
    assert tuple(x.shape) == (2, cfg.n_patches + 5, cfg.d_model)
    np.testing.assert_allclose(x.numpy(), np.asarray(wx), **TOL)
    assert np.array_equal(pos.numpy(), np.asarray(wpos))
    assert np.array_equal(pos[0].numpy(), np.arange(cfg.n_patches + 5))


def test_prefill_and_decode_match_reference(model):
    before = maple_spmm_naive.launches
    check_serving(*model, seed=1)
    assert maple_spmm_naive.launches == before     # the CPU: plain version


def test_greedy_generate_matches_reference(model):
    check_generate(*model, seed=2)


def test_head_route_matches_reference(model):
    check_head_route(*model, seed=3)


def test_the_prefix_and_the_biases_change_the_logits(model):
    _, cfg, _, params = model
    tok = torch.tensor([[5, 6, 7]])
    vis = torch.from_numpy(extras(cfg, 1, 4)["vision_embeds"])
    base, _ = lm.prefill(params, cfg, {"tokens": tok, "vision_embeds": vis})
    other, _ = lm.prefill(params, cfg, {"tokens": tok,
                                        "vision_embeds": vis + 1.0})
    assert float((base - other).abs().max()) > 1e-2
    attn = params["groups"]["b0"]["attn"]
    zeroed = dict(params, groups={"b0": dict(
        params["groups"]["b0"], attn=dict(attn, **{
            k: torch.zeros_like(attn[k]) for k in ("bq", "bk", "bv")}))})
    without, _ = lm.prefill(zeroed, cfg, {"tokens": tok,
                                          "vision_embeds": vis})
    assert float((base - without).abs().max()) > 1e-2


@pytest.mark.parametrize("n_patches", [8, 256])
def test_generate_sizes_its_cache_with_the_vision_prefix(monkeypatch,
                                                        n_patches):
    """The cache ``generate`` builds holds text + n_patches + max_new
    positions, as the reference's (``engine.py``'s ``prompt_len``)."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              n_patches=n_patches)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    lens = []
    prefill = lm.prefill

    def spy(*args, **kw):
        out = prefill(*args, **kw)
        lens.append(out[1]["groups"]["b0"]["k"].shape[2])
        return out
    monkeypatch.setattr(lm, "prefill", spy)
    batch = {"tokens": torch.tensor([[1, 2, 3, 4, 5]]),
             "vision_embeds": torch.zeros((1, n_patches, cfg.d_model))}
    tokens, _ = generate(params, cfg, batch, SamplingConfig(max_new_tokens=4))
    assert lens == [5 + n_patches + 4] and tokens.shape == (1, 4)


def test_converter_carries_the_vision_projection(model):
    cfg_ref, cfg, params_ref, params = model
    tree = flatten_ref(params_ref)
    assert np.array_equal(params["vis_proj"].numpy(), tree["vis_proj"])
    assert tuple(params["vis_proj"].shape) == (cfg.d_model, cfg.d_model)
    with pytest.raises(ValueError, match="vis_proj"):
        params_from_numpy({k: v for k, v in tree.items() if k != "vis_proj"},
                          cfg, device="cpu")
    got = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else
                tuple(getattr(v, "shape", ())) for k, v in tree.items()}
    assert shapes(got) == shapes(params)
    assert "encoder" not in got


# --------------------------------------------------------------------------
# the data pipeline's extra inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 11)])
def test_synth_batch_extras(seed, step):
    """Tokens and labels equal the reference's; the extras have the
    reference's names, shapes and dtype, are the same on every call of a
    step and differ between steps (their values are the port's own draw:
    torch cannot reproduce ``jax.random``)."""
    extra = {"vision_embeds": (2, 8, 64), "enc_frames": (2, 24, 64)}
    kw = dict(vocab_size=512, seq_len=16, global_batch=2, seed=seed)
    want = ref_synth_batch(RefDataConfig(**kw), step, extra)
    got = synth_batch(DataConfig(**kw), step, extra)
    assert list(got) == list(want)
    for k in ("tokens", "labels"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    for k, shape in extra.items():
        assert tuple(got[k].shape) == shape == want[k].shape
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        assert abs(float(got[k].std()) - 1.0) < 0.1
    again = synth_batch(DataConfig(**kw), step, extra)
    assert all(torch.equal(got[k], again[k]) for k in got)
    other = synth_batch(DataConfig(**kw), step + 1, extra)
    assert not torch.equal(got["enc_frames"], other["enc_frames"])
    assert not torch.equal(got["enc_frames"][0], got["vision_embeds"][0, :1]
                           .expand(24, 64))


# --------------------------------------------------------------------------
# entry points and what stays refused
# --------------------------------------------------------------------------

def test_serve_cli_runs_internvl_on_cpu(capsys):
    from repro_torch.launch.serve import main
    tokens = main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    assert tokens.shape == (2, 3) and "on cpu" in capsys.readouterr().out


def test_complete_static_and_paged_decode_refuse_the_prefix(model):
    cfg_ref, cfg, _, params = model
    with pytest.raises(NotImplementedError, match="vision_embeds"):
        complete_static(params, cfg, [1, 2, 3], 2,
                        sampling=SamplingConfig())
    with pytest.raises(NotImplementedError, match="vision prefixes"):
        ref_lm.init_paged_state(cfg_ref, 2, 8, 4, 4)
    with pytest.raises(NotImplementedError, match="vision prefixes"):
        lm.init_paged_state(cfg, 2, 8, 4, 4, device="cpu")


def test_training_the_vlm_family_stays_refused(model):
    """Training the vlm family was refused until the prefix trained; now
    ``forward`` over the prefix and tokens and the loss (the prefix's
    positions masked) equal the reference's
    (``test_torch_train_families`` holds the gradients)."""
    cfg_ref, cfg, params_ref, params = model
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6))
    ref_b, port_b = batches(tok[:, :5], extras(cfg, 2, 4))
    ref_b["labels"] = jnp.asarray(tok[:, 1:], jnp.int32)
    port_b["labels"] = torch.from_numpy(tok[:, 1:])
    per_layer = lm.unstack_layers(params)
    logits = lm.forward(per_layer, cfg, port_b)
    assert tuple(logits.shape[:2]) == (2, cfg.n_patches + 5)
    want_logits = jax.jit(lambda p: ref_lm.forward(p, cfg_ref, ref_b))(
        params_ref)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **LOGITS)
    want, aux_ref = jax.jit(lambda p: ref_lm.loss_fn(p, cfg_ref, ref_b))(
        params_ref)
    got, aux = lm.loss_fn(per_layer, cfg, port_b)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert int(aux["tokens"]) == int(aux_ref["tokens"]) == 10


@pytest.mark.parametrize("base,family", [("qwen2-7b", "dense"),
                                         ("recurrentgemma-9b", "hybrid"),
                                         ("recurrentgemma-9b", "vlm"),
                                         ("mamba2-2.7b", "ssm"),
                                         ("granite-moe-3b-a800m", "moe")])
def test_a_vision_prefix_outside_the_vlm_family_stays_refused(base, family):
    cfg = dataclasses.replace(configs.get_smoke_config(base), family=family,
                              n_patches=8)
    with pytest.raises(NotImplementedError, match="not ported"):
        lm.init_params(cfg, torch.Generator(), device="cpu")
