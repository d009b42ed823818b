"""Port parity: the paged decode path (``layers.attention_decode_paged``,
``lm.init_paged_state`` / ``decode_step_paged`` / ``needs_kv_pages`` /
``history_horizon``, ``paged_cache.scatter_prefill_state``) against
``repro`` on the CPU, at the smoke width (d_model 64, 4 heads, 2 KV heads,
hd 16).

Attention within 1e-5, decode logits within 1e-4 (the repo's f32
tolerances: the two packages sum in different orders); pool entries no
step writes, and everything a scatter writes from the same inputs, are
held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.serve import paged_cache as ref_pc
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import maple_spmm_naive
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import paged_cache
from test_torch_serve import flatten_ref

D, H, KVH, HD = 64, 4, 2, 16


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _attn_params(seed):
    shapes = {"wq": (D, H, HD), "wk": (D, KVH, HD), "wv": (D, KVH, HD),
              "wo": (H, HD, D)}
    p = {n: _rand(seed + i, *s, scale=D ** -0.5)
         for i, (n, s) in enumerate(shapes.items())}
    p["q_norm"] = {"scale": _rand(seed + 9, HD, scale=0.1)}
    p["k_norm"] = {"scale": _rand(seed + 10, HD, scale=0.1)}
    return p


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _paged_case(psize=4, n_pages=14, max_pages=4):
    """Four slots: three live at positions 5, 8 (the first token of a new
    page) and 2, one free (pos 0, every entry the dead page).  Every
    page, page 0 and the pages the slots hold past their positions
    included, is filled with stale values a previous occupant left."""
    pos = np.array([5, 8, 2, 0], np.int32)
    perm = np.random.default_rng(3).permutation(np.arange(1, n_pages))
    table = np.zeros((4, max_pages), np.int32)
    table[0, :2], table[1, :3], table[2, :1] = perm[:2], perm[2:5], perm[5:6]
    table[1, 3] = perm[6]            # allocated ahead, stale throughout
    pool_k = _rand(11, n_pages, psize, KVH, HD)
    pool_v = _rand(12, n_pages, psize, KVH, HD)
    return pos, table, pool_k, pool_v


def test_attention_decode_paged_matches_reference():
    ref_cfg = RL.AttnConfig(d_model=D, n_heads=H, n_kv_heads=KVH,
                            head_dim=HD, qk_norm=True, rope_theta=1e6)
    cfg = L.AttnConfig(d_model=D, n_heads=H, n_kv_heads=KVH, head_dim=HD,
                       qk_norm=True, rope_theta=1e6)
    p = _attn_params(1)
    pos, table, pool_k, pool_v = _paged_case()
    x = _rand(20, 4, 1, D)
    want, wk, wv = RL.attention_decode_paged(
        _to(p, jnp.asarray), ref_cfg, jnp.asarray(x), jnp.asarray(pool_k),
        jnp.asarray(pool_v), jnp.asarray(table), jnp.asarray(pos))
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    got, gk, gv = L.attention_decode_paged(
        _to(p, torch.from_numpy), cfg, torch.from_numpy(x), tk, tv,
        torch.from_numpy(table), torch.from_numpy(pos))
    assert gk is tk and gv is tv                   # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    written = np.zeros(pool_k.shape[:2], bool)
    written[table[np.arange(4), pos // 4], pos % 4] = True
    for g, w, before in ((gk, wk, pool_k), (gv, wv, pool_v)):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[written], w[written], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(g[~written], before[~written])
        np.testing.assert_array_equal(w[~written], before[~written])
    # the stale entries get weight exactly 0: a pool of other stale
    # values gives the same output bit for bit
    pk2, pv2 = _rand(13, *pool_k.shape), _rand(14, *pool_v.shape)
    live = np.zeros(pool_k.shape[:2], bool)
    for b in range(3):
        t = np.arange(pos[b] + 1)
        live[table[b, t // 4], t % 4] = True
    pk2[live], pv2[live] = pool_k[live], pool_v[live]
    again, _, _ = L.attention_decode_paged(
        _to(p, torch.from_numpy), cfg, torch.from_numpy(x),
        torch.from_numpy(pk2), torch.from_numpy(pv2),
        torch.from_numpy(table), torch.from_numpy(pos))
    assert torch.equal(again[:3], got[:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_paged_state_matches_reference_layout(dtype):
    cfg_ref, cfg = ref_smoke_config("qwen3-4b"), get_smoke_config("qwen3-4b")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = ref_lm.init_paged_state(cfg_ref, 3, 10, 4, 5, dtype=jdt)
    got = lm.init_paged_state(cfg, 3, 10, 4, 5, dtype=dtype, device="cpu")
    assert set(got) == set(want) and set(got["groups"]) == \
        set(want["groups"])
    for name in ("k", "v"):
        g, w = got["groups"]["b0"][name], want["groups"]["b0"][name]
        assert tuple(g.shape) == w.shape and g.dtype == dtype
        assert not g.any()
    for name in ("table", "pos"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not got[name].any()


def test_init_paged_state_refuses_what_is_not_ported():
    cfg = get_smoke_config("qwen3-4b")
    for bad in (dict(n_enc_layers=2), dict(n_patches=4)):
        with pytest.raises(NotImplementedError, match="decoder-only"):
            lm.init_paged_state(dataclasses.replace(cfg, **bad), 2, 8, 4, 4,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        lm.init_paged_state(dataclasses.replace(cfg, pattern_unit=("ssm",)),
                            2, 8, 4, 4, device="cpu")


def test_init_paged_state_refuses_a_missing_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_paged_state(get_smoke_config("qwen3-4b"), 2, 8, 4, 4)


PATTERNS = (("attn",), ("local_attn",), ("rglru",), ("ssm",),
            ("rglru", "rglru", "local_attn"), ("local_attn", "attn"),
            ("ssm", "local_attn"), ("local_attn", "local_attn", "attn"))


@pytest.mark.parametrize("unit", PATTERNS)
@pytest.mark.parametrize("window", [None, 16, 2048])
def test_needs_kv_pages_and_history_horizon_match_reference(unit, window):
    for n_layers in (1, 2, 3, 6, 7):
        kw = dict(pattern_unit=unit, window=window, n_layers=n_layers)
        cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), **kw)
        cfg_ref = dataclasses.replace(ref_smoke_config("qwen3-4b"), **kw)
        try:
            want = (ref_lm.needs_kv_pages(cfg_ref),
                    ref_lm.history_horizon(cfg_ref))
        except ValueError:                   # a heterogeneous tail
            with pytest.raises(ValueError, match="tail"):
                lm.needs_kv_pages(cfg)
            continue
        assert (lm.needs_kv_pages(cfg), lm.history_horizon(cfg)) == want


def _prefill_state(seed, layers=2, cache_len=12):
    return {"k": _rand(seed, layers, 1, cache_len, KVH, HD),
            "v": _rand(seed + 1, layers, 1, cache_len, KVH, HD)}


@pytest.mark.parametrize("pages,cache_len", [([5, 2, 7], 12),
                                              ([0, 0, 3], 12),
                                              ([4, 6, 1], 8)])
def test_scatter_prefill_state_matches_reference(pages, cache_len):
    """The same prefill caches into both packages' pools: every page the
    slot holds equal bit for bit, every other page untouched.  ``[0, 0,
    3]`` is a resumed slot whose first pages fell behind the horizon (the
    dead page); a cache of 8 for 12 tokens is a rolling local-window
    cache."""
    cfg_ref, cfg = ref_smoke_config("qwen3-4b"), get_smoke_config("qwen3-4b")
    pre = _prefill_state(7, cache_len=cache_len)
    state_ref = ref_lm.init_paged_state(cfg_ref, 3, 9, 4, 3)
    state = lm.init_paged_state(cfg, 3, 9, 4, 3, device="cpu")
    pool_before = state["groups"]["b0"]["k"].clone()
    want = ref_pc.scatter_prefill_state(
        state_ref, {"groups": {"b0": _to(pre, jnp.asarray)}}, 1, pages, 4)
    got = paged_cache.scatter_prefill_state(
        state, {"groups": {"b0": _to(pre, torch.from_numpy)}}, 1, pages, 4)
    assert got is state                               # in place
    held = [p for p in pages if p != 0]
    for name in ("k", "v"):
        g = got["groups"]["b0"][name].numpy()
        w = np.asarray(want["groups"]["b0"][name])
        np.testing.assert_array_equal(g[:, held], w[:, held])
        rest = [p for p in range(1, 9) if p not in held]
        np.testing.assert_array_equal(g[:, rest], pool_before[:, rest])
    empty = paged_cache.scatter_prefill_state(
        state, {"groups": {"b0": _to(pre, torch.from_numpy)}}, 0, [], 4)
    assert empty is state


@pytest.fixture(scope="module")
def sparse_models():
    sparse = dict(sparse_mlp=True, sparse_block=(8, 8))
    cfg_ref = dataclasses.replace(ref_smoke_config("qwen3-4b"), **sparse)
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), **sparse)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    params = params_from_numpy(flatten_ref(params_ref), cfg, device="cpu")
    return cfg_ref, cfg, params_ref, params


@pytest.mark.timeout(240)
def test_decode_step_paged_matches_reference(sparse_models):
    """qwen3-4b smoke with the sparse MLP: three requests prefilled by
    each package and scattered into their pages, a free fourth slot, then
    four teacher-forced fused steps; logits within 1e-4 at every step and
    the pools' live entries within 1e-5."""
    cfg_ref, cfg, params_ref, params = sparse_models
    psize, n_pages, max_pages = 4, 16, 5
    lens = (5, 7, 3)
    slot_pages = ([3, 9, 1, 12, 4], [7, 2, 11, 5, 6], [8, 10, 13, 14, 15])
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
    calls = maple_spmm_naive.launches
    for t in range(4):
        tok = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
        tok[3] = 0                                      # the free slot
        want, state_ref = step_ref(params_ref, state=state_ref,
                                   tokens=jnp.asarray(tok))
        got, state = lm.decode_step_paged(params, cfg, state,
                                          torch.from_numpy(tok))
        np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"fused step {t}")
        assert torch.equal(state["pos"], torch.from_numpy(pos + t + 1))
    assert maple_spmm_naive.launches == calls           # CPU: plain only
    live = np.zeros((n_pages, psize), bool)
    for slot, n in enumerate(lens):
        idx = np.arange(n + 4)
        live[np.asarray(slot_pages[slot])[idx // psize], idx % psize] = True
    for name in ("k", "v"):
        np.testing.assert_allclose(
            state["groups"]["b0"][name].numpy()[:, live],
            np.asarray(state_ref["groups"]["b0"][name])[:, live],
            rtol=1e-5, atol=1e-5)
