"""Port parity: the encoder-decoder family (whisper-base) against ``repro``
on the CPU.

Layers within 1e-5: ``layer_norm``, the plain two-layer GELU MLP,
non-causal attention, ``cross_attention``, ``encode_kv`` and
``lm.sinusoidal_positions``.  The model: whisper-base's smoke config,
initialised by the reference with every zero-initialised bias (layer
norms, the GELU MLPs) drawn non-zero and the layer norms' scales moved
off one, carried across with ``repro_torch.convert``: ``_encode`` within
1e-5; ``prefill`` and ``decode_step`` logits and caches within 1e-4, and
equal greedy tokens, through ``generate`` and through the sparse head
(``prefill(return_hidden=True)`` / ``decode_step(return_hidden=True)``);
``prefill_cross_kv`` against ``prefill``'s cross caches.  Config fields,
``param_count`` and the shape grid are held exactly.  What stays refused
is held too: paged decode with cross caches, training the family, an
encoder under another family, and ``complete_static`` (tokens only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.csr import BlockCSR as RefBlockCSR
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro.models.layers import init_sparse_linear as ref_init_sparse_linear
from repro.serve import engine as ref_engine
from repro_torch import configs
from repro_torch.convert import block_csr_from_numpy, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import (SamplingConfig, SparseLogitHead,
                               complete_static, generate)
from test_torch_serve import flatten_ref

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-base"
BIASES = ("bias", "b_in", "b_out", "bq", "bk", "bv")


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# helpers shared with test_torch_vlm
# --------------------------------------------------------------------------

def perturbed(tree, seed):
    """The reference tree with every bias leaf (``BIASES``, all zeros at
    init) drawn non-zero and every layer norm's ``scale`` (ones) moved
    off one, so a test passes only if both packages apply them."""
    rng = np.random.default_rng(seed)

    def walk(node, name, parent):
        if isinstance(node, RefBlockCSR):
            return node
        if isinstance(node, dict):
            return {k: walk(v, k, node) for k, v in node.items()}
        a = np.asarray(node)
        if name in BIASES:
            assert not a.any(), name
            return jnp.asarray(rng.standard_normal(a.shape)
                               .astype(np.float32) * 0.5)
        if name == "scale" and "bias" in parent:
            return jnp.asarray(a + rng.standard_normal(a.shape)
                               .astype(np.float32) * 0.2)
        return node
    return walk(tree, "", {})


def models(arch, seed, **over):
    """(reference config, port config, reference params, port params) of
    ``arch``'s smoke config with ``over`` applied, the reference's init
    with its biases drawn (:func:`perturbed`), carried across."""
    cfg_ref = dataclasses.replace(ref_configs.get_smoke_config(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    params_ref = perturbed(ref_lm.init_params(cfg_ref,
                                              jax.random.PRNGKey(seed)),
                           seed + 1)
    return cfg_ref, cfg, params_ref, params_from_numpy(
        flatten_ref(params_ref), cfg, device="cpu")


def extras(cfg, b, seed):
    """The non-token inputs of ``b`` requests, numpy f32."""
    out = {}
    if cfg.n_enc_layers:
        out["enc_frames"] = _rand(seed, b, cfg.enc_seq, cfg.d_model)
    if cfg.n_patches:
        out["vision_embeds"] = _rand(seed + 1, b, cfg.n_patches,
                                     cfg.d_model)
    return out


def batches(tokens, extra):
    """The same batch for both packages: (reference, port)."""
    ref = {"tokens": jnp.asarray(tokens, jnp.int32),
           **{k: jnp.asarray(v) for k, v in extra.items()}}
    port = {"tokens": torch.from_numpy(tokens),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return ref, port


def heads(cfg, seed):
    """One (8, 8) d 0.5 sparse head in both packages."""
    w_ref = ref_init_sparse_linear(jax.random.PRNGKey(seed), cfg.d_model,
                                   cfg.vocab_padded, block_shape=(8, 8),
                                   block_density=0.5)
    return (ref_engine.SparseLogitHead.build(w_ref),
            SparseLogitHead.build(block_csr_from_numpy(flatten_ref(w_ref),
                                                       device="cpu")))


def check_state(state, wstate):
    assert set(state) == set(wstate)
    for key in ("groups", "tail"):
        for bkey, cache in state.get(key, {}).items():
            assert set(cache) == set(wstate[key][bkey])
            for name, t in cache.items():
                w = np.asarray(wstate[key][bkey][name])
                assert tuple(t.shape) == w.shape, (key, bkey, name)
                np.testing.assert_allclose(t.numpy(), w, err_msg=name,
                                           **LOGITS)


def check_serving(cfg_ref, cfg, params_ref, params, seed):
    """A batch of 2 through ``prefill`` and 3 teacher-forced
    ``decode_step``: logits and every cache within 1e-4."""
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 7))
    ref_b, port_b = batches(tok, extras(cfg, 2, seed))
    max_seq = tok.shape[1] + cfg.n_patches + 3
    want, wstate = ref_engine.jitted_prefill(cfg_ref, max_seq)(
        params_ref, batch=ref_b)
    got, state = lm.prefill(params, cfg, port_b, max_seq=max_seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    check_state(state, wstate)
    assert state["pos"] == int(wstate["pos"]) == 7 + cfg.n_patches
    step = ref_engine.jitted_decode_step(cfg_ref)
    forced = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size,
                                                      (2, 3))
    for t in range(3):
        nt = forced[:, t:t + 1]
        want, wstate = step(params_ref, state=wstate,
                            tokens=jnp.asarray(nt, jnp.int32))
        got, state = lm.decode_step(params, cfg, state,
                                    torch.from_numpy(nt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"decode step {t}", **LOGITS)
    check_state(state, wstate)
    return state


def check_generate(cfg_ref, cfg, params_ref, params, seed):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (3, 6))
    ref_b, port_b = batches(tok, extras(cfg, 3, seed))
    want, want_ent = ref_engine.generate(
        params_ref, cfg_ref, ref_b, ref_engine.SamplingConfig(
            max_new_tokens=8))
    got, ent = generate(params, cfg, port_b, SamplingConfig(
        max_new_tokens=8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(ent, want_ent, **LOGITS)


def check_head_route(cfg_ref, cfg, params_ref, params, seed, new=4):
    """Each request alone with its own extras, scored by the sparse head
    through ``prefill(return_hidden=True)`` and
    ``decode_step(return_hidden=True)``, greedy: logits within 1e-4 at
    every step, equal tokens."""
    head_ref, head = heads(cfg, seed + 7)
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 5))
    extra = extras(cfg, 2, seed)
    step = ref_engine.jitted_decode_step(cfg_ref, return_hidden=True)
    max_seq = tok.shape[1] + cfg.n_patches + new
    for r in range(2):
        ref_b, port_b = batches(tok[r:r + 1], {k: v[r:r + 1]
                                               for k, v in extra.items()})
        hid_ref, wstate = ref_engine.jitted_prefill(
            cfg_ref, max_seq, return_hidden=True)(params_ref, batch=ref_b)
        hid, state = lm.prefill(params, cfg, port_b, max_seq=max_seq,
                                return_hidden=True)
        for t in range(new):
            want = np.asarray(head_ref(hid_ref))[:, -1, :cfg.vocab_size]
            got = head(hid)[:, -1, :cfg.vocab_size].numpy()
            np.testing.assert_allclose(got, want, err_msg=f"req {r} t {t}",
                                       **LOGITS)
            nxt = int(want.argmax())
            assert int(got.argmax()) == nxt
            hid_ref, wstate = step(params_ref, state=wstate,
                                   tokens=jnp.full((1, 1), nxt, jnp.int32))
            hid, state = lm.decode_step(params, cfg, state,
                                        torch.full((1, 1), nxt),
                                        return_hidden=True)


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


def test_full_config_is_the_published_one():
    c = configs.get_config(ARCH)
    assert (c.n_layers, c.n_enc_layers, c.d_model, c.n_heads, c.n_kv_heads,
            c.head_dim, c.d_ff, c.enc_seq, c.vocab_size, c.vocab_padded) == \
        (6, 6, 512, 8, 8, 64, 2048, 1536, 51_865, 53_248)
    assert (c.norm, c.activation, c.family) == ("layernorm", "gelu", "audio")
    assert c.param_count() == 104_857_600
    assert ARCH in configs.ARCHS


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 7, 64), (3, 512), (1, 5, 9, 16)])
def test_layer_norm_matches_reference(shape):
    x = _rand(1, *shape, scale=3.0) + 1.5
    w, b = _rand(2, shape[-1]) + 1.0, _rand(3, shape[-1])
    want = RL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = L.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    p = {"scale": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    assert torch.equal(L.apply_norm(torch.from_numpy(x), p, "layernorm"),
                       got)


def test_layer_norm_init_and_dtype_match_reference():
    want = RL.init_norm(jax.random.PRNGKey(0), 32, "layernorm")
    got = L.init_norm(32, "layernorm", stack=(3,))
    assert set(got) == set(want) == {"scale", "bias"}
    for k in want:
        assert got[k].shape == (3, 32) and got[k].dtype == torch.float32
        assert np.array_equal(got[k][1].numpy(), np.asarray(want[k]))
    assert set(L.init_norm(32, "rmsnorm")) == {"scale"}
    x = _rand(4, 2, 5, 32).astype(jnp.bfloat16)
    w, b = _rand(5, 32), _rand(6, 32)
    want = RL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = L.layer_norm(torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_gelu_mlp_matches_reference():
    d, f = 64, 128
    p = {"w_in": _rand(10, d, f, scale=d ** -0.5), "b_in": _rand(11, f),
         "w_out": _rand(12, f, d, scale=f ** -0.5), "b_out": _rand(13, d)}
    x = _rand(14, 2, 9, d)
    want = RL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  "gelu")
    got = L.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x), "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_mlp_init_matches_reference_and_refuses_sparse():
    want = RL.init_mlp(jax.random.PRNGKey(0), 64, 128, "gelu")
    got = L.init_mlp(torch.Generator().manual_seed(0), 64, 128, "gelu",
                     stack=(2,))
    assert set(got) == set(want) == {"w_in", "b_in", "w_out", "b_out"}
    for k in want:
        assert tuple(got[k].shape) == (2, *want[k].shape), k
    assert not got["b_in"].any() and not got["b_out"].any()
    with pytest.raises(ValueError, match="gated"):
        RL.init_mlp(jax.random.PRNGKey(0), 64, 128, "gelu", sparse_down=True)
    with pytest.raises(ValueError, match="gated"):
        L.init_mlp(torch.Generator(), 64, 128, "gelu", sparse_down=True)


def _attn(kvh, bias, seed=20):
    """(reference config, port config, reference params, port params):
    d_model 64, 4 heads of 16 over ``kvh`` KV heads, non-causal."""
    d, h, hd = 64, 4, 16
    kw = dict(d_model=d, n_heads=h, n_kv_heads=kvh, head_dim=hd,
              causal=False, qkv_bias=bias)
    shapes = {"wq": (d, h, hd), "wk": (d, kvh, hd), "wv": (d, kvh, hd),
              "wo": (h, hd, d)}
    if bias:
        shapes.update(bq=(h, hd), bk=(kvh, hd), bv=(kvh, hd))
    p = {n: _rand(seed + i, *s, scale=d ** -0.5)
         for i, (n, s) in enumerate(shapes.items())}
    return (RL.AttnConfig(**kw), L.AttnConfig(**kw),
            {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("kvh,bias", [(4, False), (2, True), (1, True)])
def test_non_causal_attention_matches_reference(kvh, bias):
    ref_cfg, cfg, pj, pt = _attn(kvh, bias)
    x = _rand(1, 2, 24, 64)
    pos = np.broadcast_to(np.arange(24), (2, 24)).copy()
    want = RL.attention(pj, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention(pt, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the last query sees every key: changing the first token moves it
    x2 = x.copy()
    x2[:, 0] += 1.0
    moved = L.attention(pt, cfg, torch.from_numpy(x2), torch.from_numpy(pos))
    assert float((moved[:, -1] - got[:, -1]).abs().max()) > 1e-3


@pytest.mark.parametrize("kvh,bias", [(4, False), (2, True)])
@pytest.mark.parametrize("sq", [1, 7])
def test_cross_attention_and_encode_kv_match_reference(kvh, bias, sq):
    ref_cfg, cfg, pj, pt = _attn(kvh, bias, seed=30)
    enc = _rand(2, 2, 24, 64)
    x = _rand(3, 2, sq, 64)
    wk, wv = RL.encode_kv(pj, ref_cfg, jnp.asarray(enc))
    gk, gv = L.encode_kv(pt, cfg, torch.from_numpy(enc))
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    assert tuple(gk.shape) == (2, 24, kvh, 16)
    want = RL.cross_attention(pj, ref_cfg, jnp.asarray(x), wk, wv)
    got = L.cross_attention(pt, cfg, torch.from_numpy(x), gk, gv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seq,dim", [(24, 64), (256, 512), (7, 10)])
def test_sinusoidal_positions_match_reference(seq, dim):
    want = np.asarray(ref_lm.sinusoidal_positions(seq, dim))
    got = lm.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_full_size_sinusoidal_table_is_the_f32_rounding_of_exact():
    """At whisper-base's (1536, 512) the angles reach 1535, whose f32
    ulp is 1.2e-4: the two packages' tables then differ by 6.1e-5 where
    exp / sin round one ulp apart, and each is as close to the float64
    table as the f32 angle allows (twice its half-ulp, 1.8e-4)."""
    seq, dim = 1536, 512
    pos = np.arange(seq)[:, None]
    ang = pos * np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    exact = np.zeros((seq, dim))
    exact[:, 0::2], exact[:, 1::2] = np.sin(ang), np.cos(ang)
    limit = 2 * (seq - 1) * 2.0 ** -24
    got = lm.sinusoidal_positions(seq, dim).numpy()
    want = np.asarray(ref_lm.sinusoidal_positions(seq, dim))
    assert np.abs(got - exact).max() <= limit
    assert np.abs(want - exact).max() <= limit
    np.testing.assert_allclose(got[:256], want[:256], **TOL)


# --------------------------------------------------------------------------
# the smoke model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return models(ARCH, 0)


def test_encode_matches_reference(model):
    cfg_ref, cfg, params_ref, params = model
    frames = _rand(5, 2, cfg.enc_seq, cfg.d_model)
    want = ref_lm._encode(params_ref, cfg_ref, jnp.asarray(frames), False)
    got = lm._encode(params, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x, pos = lm._embed_inputs(params, cfg, {"tokens": torch.tensor(
        [[1, 2, 3]])})
    wx, wpos = ref_lm._embed_inputs(params_ref, cfg_ref, {
        "tokens": jnp.asarray([[1, 2, 3]])})
    np.testing.assert_allclose(x.numpy(), np.asarray(wx), **TOL)
    assert np.array_equal(pos.numpy(), np.asarray(wpos))


def test_prefill_and_decode_match_reference(model):
    check_serving(*model, seed=1)


def test_greedy_generate_matches_reference(model):
    check_generate(*model, seed=2)


def test_head_route_matches_reference(model):
    check_head_route(*model, seed=3)


def test_the_biases_change_the_logits(model):
    """Zeroing the drawn biases moves the logits, so the parity above
    holds with them in play."""
    _, cfg, _, params = model
    batch = {"tokens": torch.tensor([[5, 6, 7]]),
             "enc_frames": torch.from_numpy(_rand(6, 1, cfg.enc_seq,
                                                  cfg.d_model))}

    def zero(tree):
        return {k: zero(v) if isinstance(v, dict) else
                (torch.zeros_like(v) if k in BIASES else v)
                for k, v in tree.items()}
    with_b, _ = lm.prefill(params, cfg, batch)
    without, _ = lm.prefill(zero(params), cfg, batch)
    assert float((with_b - without).abs().max()) > 1e-2


def test_prefill_cross_kv_fills_prefills_cross_caches(model):
    """Into an empty ``init_decode_state``: equal to ``prefill``'s cross
    caches (bit for bit: the same encoder and projections) and within
    1e-5 of the reference's ``prefill_cross_kv``; the self-attention
    caches and ``pos`` untouched."""
    cfg_ref, cfg, params_ref, params = model
    frames = _rand(7, 2, cfg.enc_seq, cfg.d_model)
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 5))
    _, pre = lm.prefill(params, cfg, {"tokens": torch.from_numpy(tok),
                                      "enc_frames": torch.from_numpy(frames)},
                        max_seq=9)
    empty = lm.init_decode_state(cfg, 2, 9, device="cpu")
    state = lm.prefill_cross_kv(params, cfg, empty, torch.from_numpy(frames))
    want = ref_lm.prefill_cross_kv(params_ref, cfg_ref,
                                   ref_lm.init_decode_state(cfg_ref, 2, 9),
                                   jnp.asarray(frames))
    cache = state["groups"]["b0"]
    assert state["pos"] == 0 and not cache["k"].any()
    for name in ("cross_k", "cross_v"):
        assert tuple(cache[name].shape) == (cfg.n_layers, 2, cfg.enc_seq,
                                            cfg.n_kv_heads, cfg.head_dim)
        assert cache[name].any()
        assert torch.equal(cache[name], pre["groups"]["b0"][name])
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(want["groups"]["b0"][name]),
                                   **TOL)
    with pytest.raises(ValueError, match="no encoder"):
        qcfg = configs.get_smoke_config("qwen2-7b")
        lm.prefill_cross_kv(lm.init_params(qcfg, torch.Generator(),
                                           device="cpu"), qcfg, {}, None)


def test_decode_from_prefill_cross_kv_matches_prefill(model):
    """A decoder state whose self-attention caches come from ``prefill``
    and whose cross caches are rewritten by ``prefill_cross_kv`` decodes
    the same logits."""
    _, cfg, _, params = model
    frames = torch.from_numpy(_rand(8, 1, cfg.enc_seq, cfg.d_model))
    batch = {"tokens": torch.tensor([[3, 1, 4, 1]]), "enc_frames": frames}
    _, state = lm.prefill(params, cfg, batch, max_seq=6)
    _, again = lm.prefill(params, cfg, batch, max_seq=6)
    for name in ("cross_k", "cross_v"):
        again["groups"]["b0"][name].zero_()
    again = lm.prefill_cross_kv(params, cfg, again, frames)
    nt = torch.tensor([[9]])
    want, _ = lm.decode_step(params, cfg, state, nt)
    got, _ = lm.decode_step(params, cfg, again, nt)
    assert torch.equal(got, want)


def test_init_params_and_decode_state_have_the_reference_layout(model):
    cfg_ref, cfg, params_ref, params = model
    got = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(got) == shapes(params_ref) == shapes(params)
    assert set(got["encoder"]) == {"groups", "final_norm"}
    enc = got["encoder"]["groups"]["b0"]
    assert enc["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert "cross" not in enc and "cross" in got["groups"]["b0"]
    assert torch.equal(got["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert not got["groups"]["b0"]["mlp"]["b_in"].any()
    state = lm.init_decode_state(cfg, 2, 12, device="cpu")
    want = ref_lm.init_decode_state(cfg_ref, 2, 12)
    assert shapes({k: v for k, v in state.items() if k != "pos"}) == \
        shapes({k: v for k, v in want.items() if k != "pos"})


def test_converter_carries_the_encoder(model):
    cfg_ref, cfg, params_ref, params = model
    tree = flatten_ref(params_ref)
    for path in (("encoder", "groups", "b0", "attn", "wq"),
                 ("encoder", "groups", "b0", "norm1", "bias"),
                 ("encoder", "final_norm", "bias"),
                 ("groups", "b0", "cross", "wk"),
                 ("groups", "b0", "cross_norm", "bias"),
                 ("groups", "b0", "mlp", "b_out")):
        got, want = params, tree
        for k in path:
            got, want = got[k], want[k]
        assert np.array_equal(got.numpy(), want), path
    assert params["encoder"]["groups"]["b0"]["mlp"]["w_in"].shape[0] == \
        cfg.n_enc_layers
    bad = dict(tree, encoder=dict(tree["encoder"], groups={"b0": dict(
        tree["encoder"]["groups"]["b0"], norm2={
            k: v[:1] for k, v in
            tree["encoder"]["groups"]["b0"]["norm2"].items()})}))
    with pytest.raises(ValueError, match="/encoder/groups/b0/norm2"):
        params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        params_from_numpy({k: v for k, v in tree.items() if k != "encoder"},
                          cfg, device="cpu")


# --------------------------------------------------------------------------
# entry points and what stays refused
# --------------------------------------------------------------------------

def test_serve_cli_runs_whisper_on_cpu(capsys):
    from repro_torch.launch.serve import main
    tokens = main(["--arch", ARCH, "--smoke", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    assert tokens.shape == (2, 3) and "on cpu" in capsys.readouterr().out


def test_complete_static_refuses_models_with_extra_inputs(model):
    _, cfg, _, params = model
    with pytest.raises(NotImplementedError, match="enc_frames"):
        complete_static(params, cfg, [1, 2, 3], 2,
                        sampling=SamplingConfig())


def test_paged_decode_with_cross_caches_stays_refused(model):
    cfg_ref, cfg, _, _ = model
    with pytest.raises(NotImplementedError, match="cross caches"):
        ref_lm.init_paged_state(cfg_ref, 2, 8, 4, 4)
    with pytest.raises(NotImplementedError, match="cross caches"):
        lm.init_paged_state(cfg, 2, 8, 4, 4, device="cpu")


def test_training_the_audio_family_stays_refused(model):
    """Training the audio family was refused until the encoder trained;
    now the loss over tokens and encoder frames equals the reference's
    (``test_torch_train_families`` holds the gradients)."""
    cfg_ref, cfg, params_ref, params = model
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6))
    ref_b, port_b = batches(tok[:, :5], extras(cfg, 2, 4))
    ref_b["labels"] = jnp.asarray(tok[:, 1:], jnp.int32)
    port_b["labels"] = torch.from_numpy(tok[:, 1:])
    want, _ = jax.jit(lambda p: ref_lm.loss_fn(p, cfg_ref, ref_b))(params_ref)
    got, _ = lm.loss_fn(lm.unstack_layers(params), cfg, port_b)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_an_encoder_outside_the_audio_family_stays_refused(family):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), family=family)
    with pytest.raises(NotImplementedError, match="not ported"):
        lm.init_params(cfg, torch.Generator(), device="cpu")
