"""Port parity: ``repro_torch.models.layers`` and ``repro_torch.configs``
against ``repro``, one layer at a time, at f32 tolerance 1e-5 (the two
sum in different orders).  Inputs are numpy arrays made from a seed and
fed to both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core.csr import BlockCSR as RefBlockCSR
from repro.models import layers as RL
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.csr import BlockCSR
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("getters", [(get_config, ref_get_config),
                                     (get_smoke_config, ref_get_smoke_config)])
def test_config_fields_equal_reference(getters):
    port, ref = (g("qwen3-4b") for g in getters)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.vocab_padded == ref.vocab_padded
    assert port.layer_plan() == ref.layer_plan()
    assert port.block_kinds() == ref.block_kinds()


def test_rms_norm_and_rope_match_reference():
    x, w = _rand(0, 2, 5, 3, 16), _rand(1, 16, scale=0.1)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(RL.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    pos = np.random.default_rng(2).integers(0, 500, (2, 5))
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         theta).numpy(),
            np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     theta)), rtol=1e-4, atol=1e-4)


def _attn_params(seed, d, h, kvh, hd):
    names = ("wq", "wk", "wv", "wo")
    shapes = ((d, h, hd), (d, kvh, hd), (d, kvh, hd), (h, hd, d))
    p = {n: _rand(seed + i, *s, scale=d ** -0.5)
         for i, (n, s) in enumerate(zip(names, shapes))}
    p["q_norm"] = {"scale": _rand(seed + 9, hd, scale=0.1)}
    p["k_norm"] = {"scale": _rand(seed + 10, hd, scale=0.1)}
    return p


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_attention_prefill_and_decode_match_reference():
    d, h, kvh, hd, s = 32, 4, 2, 8, 6
    ref_cfg = RL.AttnConfig(d_model=d, n_heads=h, n_kv_heads=kvh,
                            head_dim=hd, qk_norm=True, rope_theta=1e6)
    cfg = L.AttnConfig(d_model=d, n_heads=h, n_kv_heads=kvh, head_dim=hd,
                       qk_norm=True, rope_theta=1e6)
    p = _attn_params(3, d, h, kvh, hd)
    pj, pt = _to(p, jnp.asarray), _to(p, torch.from_numpy)
    x = _rand(20, 2, s, d)
    pos = np.broadcast_to(np.arange(s), (2, s))
    pos_t = torch.from_numpy(pos.copy())
    rope = L.rope_tables(pos_t, hd, 1e6)
    want = RL.attention(pj, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention(pt, cfg, torch.from_numpy(x), pos_t, rope=rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, wk, wv = RL.attention_prefill(pj, ref_cfg, jnp.asarray(x),
                                        jnp.asarray(pos), cache_len=s + 2)
    got, gk, gv = L.attention_prefill(pt, cfg, torch.from_numpy(x), pos_t,
                                      cache_len=s + 2, rope=rope)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    xt = _rand(21, 2, 1, d)
    want, _, _ = RL.attention_decode(pj, ref_cfg, jnp.asarray(xt), wk, wv, s)
    rope1 = L.rope_tables(torch.full((2, 1), s), hd, 1e6)
    got, gk2, _ = L.attention_decode(pt, cfg, torch.from_numpy(xt), gk, gv,
                                     s, rope=rope1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert gk2 is gk and bool(gk[:, s].abs().sum() > 0)   # updated in place


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_attention_takes_positions_like_the_reference(batch):
    """Both packages called the same positional way, positions in the
    reference's slot: the port computes RoPE from them (a (B, S) int
    tensor must never be read as a (cos, sin) pair), and refuses a tuple
    there."""
    d, h, kvh, hd, s = 64, 4, 2, 16, 8
    ref_cfg = RL.AttnConfig(d_model=d, n_heads=h, n_kv_heads=kvh,
                            head_dim=hd)
    cfg = L.AttnConfig(d_model=d, n_heads=h, n_kv_heads=kvh, head_dim=hd)
    p = _attn_params(30 + batch, d, h, kvh, hd)
    del p["q_norm"], p["k_norm"]
    pj, pt = _to(p, jnp.asarray), _to(p, torch.from_numpy)
    x = _rand(40 + batch, batch, s, d)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (batch, s)).copy()
    tol = dict(rtol=1e-4, atol=1e-4)
    want = RL.attention(pj, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention(pt, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    want, wk, wv = RL.attention_prefill(pj, ref_cfg, jnp.asarray(x),
                                        jnp.asarray(pos), cache_len=s + 1)
    got, gk, gv = L.attention_prefill(pt, cfg, torch.from_numpy(x),
                                      torch.from_numpy(pos), cache_len=s + 1)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    xt = _rand(50 + batch, batch, 1, d)
    want, _, _ = RL.attention_decode(pj, ref_cfg, jnp.asarray(xt), wk, wv, s)
    got, _, _ = L.attention_decode(pt, cfg, torch.from_numpy(xt), gk, gv, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    rope = L.rope_tables(torch.from_numpy(pos), hd, cfg.rope_theta)
    with pytest.raises(TypeError, match="rope="):
        L.attention(pt, cfg, torch.from_numpy(x), rope)


@pytest.mark.parametrize("sparse", [False, True])
def test_mlp_matches_reference(sparse):
    d, f = 16, 32
    p = {"w_gate": _rand(30, d, f, scale=0.25), "w_up": _rand(31, d, f,
                                                              scale=0.25)}
    x = _rand(33, 2, 5, d)
    if sparse:
        mask = np.random.default_rng(34).random((2, 4)) < 0.5
        dense = _rand(32, d, f) * np.repeat(np.repeat(mask, 8, 0), 8, 1)
        pj = dict(p, w_down=RefBlockCSR.from_dense(dense, (8, 8)))
        pt = dict(_to(p, torch.from_numpy),
                  w_down=BlockCSR.from_dense(dense, (8, 8), device="cpu"))
        pj = {k: v if k == "w_down" else jnp.asarray(v)
              for k, v in pj.items()}
    else:
        p["w_down"] = _rand(32, f, d, scale=0.2)
        pj, pt = _to(p, jnp.asarray), _to(p, torch.from_numpy)
    want = RL.mlp(pj, jnp.asarray(x), "silu")
    got = L.mlp(pt, torch.from_numpy(x), "silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(7, 24), (2, 3, 24), (24,)])
def test_sparse_linear_matches_reference(shape):
    w = _rand(40, 16, 24) * np.repeat(np.repeat(
        np.random.default_rng(41).random((2, 3)) < 0.6, 8, 0), 8, 1)
    x = _rand(42, *shape)
    want = RL.sparse_linear(RefBlockCSR.from_dense(w, (8, 8)), jnp.asarray(x),
                            bn=16)
    got = L.sparse_linear(BlockCSR.from_dense(w, (8, 8), device="cpu"),
                          torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bn", [16, 32])
def test_sparse_linear_takes_bn_like_the_reference(bn):
    w = _rand(43, 16, 24) * np.repeat(np.repeat(
        np.random.default_rng(44).random((2, 3)) < 0.6, 8, 0), 8, 1)
    x = _rand(45, 2, 5, 24)
    want = RL.sparse_linear(RefBlockCSR.from_dense(w, (8, 8)), jnp.asarray(x),
                            bn=bn)
    got = L.sparse_linear(BlockCSR.from_dense(w, (8, 8), device="cpu"),
                          torch.from_numpy(x), bn=bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_param_count_equals_reference(arch, getter):
    get, ref_get = ((get_config, ref_get_config) if getter == "full"
                    else (get_smoke_config, ref_get_smoke_config))
    port, ref = get(arch), ref_get(arch)
    for active in (False, True):
        assert port.param_count(active_only=active) == \
            ref.param_count(active_only=active)
    assert port.param_count() == ref.param_count()


def test_init_sparse_linear_fallback_pattern_equals_reference():
    """At density 0 every block-row keeps only its fallback block
    ``(i, i mod gk)`` — the one part of the draw both packages fix."""
    import jax
    ref = RL.init_sparse_linear(jax.random.PRNGKey(0), 32, 48,
                                block_shape=(8, 8), block_density=0.0)
    got = L.init_sparse_linear(torch.Generator().manual_seed(0), 32, 48,
                               block_shape=(8, 8), block_density=0.0)
    for name in ("block_col", "block_row", "row_ptr"):
        assert np.array_equal(getattr(got, name),
                              np.asarray(getattr(ref, name))), name
    got.check_pad_contract()
    stacked = L.init_sparse_linear(torch.Generator().manual_seed(0), 32, 48,
                                   block_shape=(8, 8), block_density=0.5,
                                   stack=(3,))
    assert stacked.blocks.shape == (3, stacked.nnzb, 8, 8)
    assert (np.diff(stacked.row_ptr) > 0).all()


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_with_qkv_bias_matches_reference(qk_norm):
    """QKV biases (random, non-zero) are added before the q/k norm and
    RoPE, in full, prefill, decode and paged decode attention."""
    d, h, kvh, hd, s = 32, 4, 2, 8, 6
    kw = dict(d_model=d, n_heads=h, n_kv_heads=kvh, head_dim=hd,
              qk_norm=qk_norm, qkv_bias=True, rope_theta=1e6)
    ref_cfg, cfg = RL.AttnConfig(**kw), L.AttnConfig(**kw)
    p = _attn_params(60, d, h, kvh, hd)
    if not qk_norm:
        del p["q_norm"], p["k_norm"]
    p.update(bq=_rand(61, h, hd), bk=_rand(62, kvh, hd), bv=_rand(63, kvh, hd))
    pj, pt = _to(p, jnp.asarray), _to(p, torch.from_numpy)
    x = _rand(64, 2, s, d)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want = RL.attention(pj, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention(pt, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    no_bias = L.attention(_to(dict(p, bq=0 * p["bq"], bk=0 * p["bk"],
                                   bv=0 * p["bv"]), torch.from_numpy), cfg,
                          torch.from_numpy(x), torch.from_numpy(pos))
    assert float((no_bias - got).abs().max()) > 1e-2
    want, wk, wv = RL.attention_prefill(pj, ref_cfg, jnp.asarray(x),
                                        jnp.asarray(pos), cache_len=s + 1)
    got, gk, gv = L.attention_prefill(pt, cfg, torch.from_numpy(x),
                                      torch.from_numpy(pos), cache_len=s + 1)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    xt = _rand(65, 2, 1, d)
    want, _, _ = RL.attention_decode(pj, ref_cfg, jnp.asarray(xt), wk, wv, s)
    got, _, _ = L.attention_decode(pt, cfg, torch.from_numpy(xt), gk, gv, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pool_k, pool_v = _rand(66, 5, 4, kvh, hd), _rand(67, 5, 4, kvh, hd)
    table = np.array([[2, 4], [1, 3]], np.int32)
    ppos = np.array([5, 2], np.int32)
    want, _, _ = RL.attention_decode_paged(
        pj, ref_cfg, jnp.asarray(xt), jnp.asarray(pool_k),
        jnp.asarray(pool_v), jnp.asarray(table), jnp.asarray(ppos))
    got, _, _ = L.attention_decode_paged(
        pt, cfg, torch.from_numpy(xt), torch.from_numpy(pool_k.copy()),
        torch.from_numpy(pool_v.copy()), torch.from_numpy(table),
        torch.from_numpy(ppos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_attention_with_qkv_bias_matches_reference_layout():
    import jax
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              qkv_bias=True)
    ref = RL.init_attention(jax.random.PRNGKey(0), RL.AttnConfig(**kw))
    got = L.init_attention(torch.Generator().manual_seed(0),
                           L.AttnConfig(**kw), stack=(3,))
    assert sorted(got) == sorted(ref)
    for k in ("bq", "bk", "bv"):
        assert tuple(got[k].shape) == (3, *ref[k].shape)
        assert not got[k].any() and not np.asarray(ref[k]).any()
    plain = L.init_attention(torch.Generator().manual_seed(0),
                             L.AttnConfig(**dict(kw, qkv_bias=False)))
    assert not {"bq", "bk", "bv"} & set(plain)
