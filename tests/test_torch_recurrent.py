"""Port parity: the recurrent families against ``repro`` on the CPU.

Layers: windowed ``attention_prefill`` (on ``ops.local_block_attention``'s
plain version here) with its rolling cache, rolling ``attention_decode``,
windowed ``attention_decode_paged`` and the GeGLU ``mlp``, dense and
sparse, within 1e-5.  Models: recurrentgemma-9b (RG-LRU + local
attention, a tail of two RG-LRU layers) and mamba2-2.7b (SSD) at their
smoke configs, initialised by the reference and carried across with
``repro_torch.convert``: prefill and decode logits within 1e-4 and equal
greedy tokens.  Configs, ``param_count`` and the converter's tail are
held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.csr import BlockCSR as RefBlockCSR
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels.block_attn import block_attention
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import SamplingConfig, generate
from test_torch_serve import flatten_ref

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
RECURRENT = ["recurrentgemma-9b", "mamba2-2.7b"]
D, H, KVH, HD, WINDOW = 64, 4, 1, 16, 16


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _attn(window=WINDOW):
    """(reference config, port config, reference params, port params):
    recurrentgemma's smoke attention, 4 heads over 1 KV head."""
    kw = dict(d_model=D, n_heads=H, n_kv_heads=KVH, head_dim=HD,
              window=window)
    shapes = {"wq": (D, H, HD), "wk": (D, KVH, HD), "wv": (D, KVH, HD),
              "wo": (H, HD, D)}
    p = {n: _rand(40 + i, *s, scale=D ** -0.5)
         for i, (n, s) in enumerate(shapes.items())}
    return (RL.AttnConfig(**kw), L.AttnConfig(**kw), _to(p, jnp.asarray),
            _to(p, torch.from_numpy))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_config_fields_and_param_count_equal_reference(arch, getter):
    get, ref_get = ((get_config, ref_get_config) if getter == "full"
                    else (get_smoke_config, ref_smoke_config))
    port, ref = get(arch), ref_get(arch)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.layer_plan() == ref.layer_plan()
    assert port.param_count() == ref.param_count()
    assert lm.needs_kv_pages(port) == ref_lm.needs_kv_pages(ref)
    assert lm.history_horizon(port) == ref_lm.history_horizon(ref)
    assert arch in ARCHS


def test_full_configs_count_the_reference_parameters():
    assert get_config("recurrentgemma-9b").param_count() == 10_443_816_960
    assert get_config("mamba2-2.7b").param_count() == 2_833_776_640
    unit, groups, tail = get_config("recurrentgemma-9b").layer_plan()
    assert (unit, groups, tail) == (("rglru", "rglru", "local_attn"), 12,
                                    ("rglru", "rglru"))
    kinds = get_config("recurrentgemma-9b").block_kinds()
    assert kinds.count("local_attn") == 12 and kinds.count("rglru") == 26


# --------------------------------------------------------------------------
# local-window attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", [24, 37, 130])
@pytest.mark.parametrize("cache", ["above", "window"])
def test_windowed_prefill_and_rolling_cache_match_reference(s, cache):
    """Out within 1e-5; the cache below S in rolling layout (slot
    ``t % cache_len`` holds position ``t``), exactly the rearrangement of
    the prompt's own K/V, and within 1e-5 of the reference's."""
    ref_cfg, cfg, pj, pt = _attn()
    cache_len = s + 3 if cache == "above" else WINDOW
    x = _rand(s, 2, s, D)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    want, wk, wv = RL.attention_prefill(pj, ref_cfg, jnp.asarray(x),
                                        jnp.asarray(pos),
                                        cache_len=cache_len)
    before = block_attention.launches
    got, gk, gv = L.attention_prefill(pt, cfg, torch.from_numpy(x),
                                      torch.from_numpy(pos),
                                      cache_len=cache_len)
    assert block_attention.launches == before      # the CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    _, fk, fv = L.attention_prefill(pt, cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos), cache_len=s)
    slots = np.arange(s)[-min(cache_len, s):]
    for g, full in ((gk, fk), (gv, fv)):
        assert tuple(g.shape) == (2, cache_len, KVH, HD)
        assert torch.equal(g[:, slots % cache_len], full[:, slots])
        if cache_len > s:
            assert not g[:, s:].any()
    # attention without a cache takes chunked_attention, the reference's
    # training route, for the same function
    out = L.attention(pt, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(RL.attention(
        pj, ref_cfg, jnp.asarray(x), jnp.asarray(pos))), **TOL)
    np.testing.assert_allclose(out.numpy(), got.numpy(), **TOL)


def test_windowed_prefill_is_local_block_attention_on_padded_heads(
        monkeypatch):
    """The windowed prefill is one ``ops.local_block_attention`` call on
    K/V repeated to every head and S padded to the 128-tiles; attention
    without a cache (the training route) makes none."""
    _, cfg, _, pt = _attn()
    calls = []
    real = L.ops.local_block_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(L.ops, "local_block_attention", spy)
    x = torch.from_numpy(_rand(0, 1, 130, D))
    L.attention_prefill(pt, cfg, x, torch.arange(130)[None],
                        cache_len=WINDOW)
    L.attention(pt, cfg, x, torch.arange(130)[None])
    assert calls == [((1, 256, H, HD), (1, 256, H, HD),
                      dict(window=WINDOW, bq=128, bk=128))]


def test_rolling_decode_matches_reference():
    """A window-long cache decoding past the window: slots wrap, each
    step's output within 1e-5, the caches too."""
    ref_cfg, cfg, pj, pt = _attn()
    s = 37
    x = _rand(1, 2, s, D)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    _, wk, wv = RL.attention_prefill(pj, ref_cfg, jnp.asarray(x),
                                     jnp.asarray(pos), cache_len=WINDOW)
    gk, gv = torch.from_numpy(np.array(wk)), torch.from_numpy(np.array(wv))
    for t in range(20):
        xt = _rand(100 + t, 2, 1, D)
        want, wk, wv = RL.attention_decode(pj, ref_cfg, jnp.asarray(xt), wk,
                                           wv, jnp.int32(s + t))
        got, gk2, _ = L.attention_decode(pt, cfg, torch.from_numpy(xt), gk,
                                         gv, s + t)
        assert gk2 is gk                               # in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


def test_windowed_paged_decode_matches_reference():
    """Four slots at positions 9, 14, 3 and 0 (free) over pages of 4
    holding stale values everywhere: the window masks what lies at or
    before ``pos - window`` as the reference does."""
    ref_cfg, cfg, pj, pt = _attn(window=6)
    psize, n_pages = 4, 16
    pos = np.array([9, 14, 3, 0], np.int32)
    perm = np.random.default_rng(3).permutation(np.arange(1, n_pages))
    table = np.zeros((4, 4), np.int32)
    table[0, :3], table[1, :4], table[2, :1] = perm[:3], perm[3:7], perm[7:8]
    pool_k = _rand(11, n_pages, psize, KVH, HD)
    pool_v = _rand(12, n_pages, psize, KVH, HD)
    x = _rand(20, 4, 1, D)
    want, wk, _ = RL.attention_decode_paged(
        pj, ref_cfg, jnp.asarray(x), jnp.asarray(pool_k),
        jnp.asarray(pool_v), jnp.asarray(table), jnp.asarray(pos))
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    got, _, _ = L.attention_decode_paged(
        pt, cfg, torch.from_numpy(x), tk, tv, torch.from_numpy(table),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), **TOL)
    # what lies behind the window gets weight exactly 0
    behind = np.zeros((n_pages, psize), bool)
    for b in range(3):
        t = np.arange(max(0, pos[b] - 6 + 1))
        behind[table[b, t // psize], t % psize] = True
    pk2 = pool_k.copy()
    pk2[behind] = _rand(13, int(behind.sum()), KVH, HD)
    again, _, _ = L.attention_decode_paged(
        pt, cfg, torch.from_numpy(x), torch.from_numpy(pk2),
        torch.from_numpy(pool_v.copy()), torch.from_numpy(table),
        torch.from_numpy(pos))
    assert torch.equal(again[:3], got[:3])


# --------------------------------------------------------------------------
# the GeGLU MLP
# --------------------------------------------------------------------------

def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(L.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sparse", [False, True])
def test_gelu_glu_mlp_matches_reference(sparse):
    d, f = 16, 48
    p = {"w_gate": _rand(1, d, f, scale=0.3), "w_up": _rand(2, d, f,
                                                           scale=0.3)}
    down = _rand(3, f, d, scale=0.2)
    x = _rand(4, 2, 5, d)
    pj, pt = _to(p, jnp.asarray), _to(p, torch.from_numpy)
    if sparse:
        keep = np.random.default_rng(5).random((d // 8, f // 8)) < 0.5
        w = down.T * np.repeat(np.repeat(keep, 8, 0), 8, 1)
        pj["w_down"] = RefBlockCSR.from_dense(w, (8, 8))
        pt["w_down"] = BlockCSR.from_dense(w, (8, 8), device="cpu")
    else:
        pj["w_down"], pt["w_down"] = jnp.asarray(down), \
            torch.from_numpy(down)
    want = RL.mlp(pj, jnp.asarray(x), "gelu_glu")
    got = L.mlp(pt, torch.from_numpy(x), "gelu_glu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_mlp_takes_gelu_glu():
    p = L.init_mlp(torch.Generator().manual_seed(0), 16, 48, "gelu_glu",
                   stack=(2,))
    assert tuple(p["w_gate"].shape) == (2, 16, 48)
    # "gelu" is the plain two-layer MLP; only its sparse down-projection
    # stays refused, as in the reference
    plain = L.init_mlp(torch.Generator(), 16, 48, "gelu", stack=(2,))
    assert set(plain) == {"w_in", "b_in", "w_out", "b_out"}
    with pytest.raises(ValueError, match="gated"):
        L.init_mlp(torch.Generator(), 16, 48, "gelu", sparse_down=True)


# --------------------------------------------------------------------------
# the two smoke models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=RECURRENT)
def model(request):
    arch = request.param
    cfg_ref, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    return arch, cfg_ref, cfg, params_ref, params_from_numpy(
        flatten_ref(params_ref), cfg, device="cpu")


def test_prefill_and_decode_match_reference(model):
    arch, cfg_ref, cfg, params_ref, params = model
    s = 40 if arch == "recurrentgemma-9b" else 64     # SSD: two chunks
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s))
    want, wstate = ref_engine.jitted_prefill(cfg_ref, s + 3)(
        params_ref, batch={"tokens": jnp.asarray(tok)})
    got, state = lm.prefill(params, cfg, {"tokens": torch.from_numpy(tok)},
                            max_seq=s + 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert set(state) == set(wstate)
    for key in ("groups", "tail"):
        for bkey, cache in state.get(key, {}).items():
            for name, t in cache.items():
                w = np.asarray(wstate[key][bkey][name])
                assert tuple(t.shape) == w.shape, (key, bkey, name)
                np.testing.assert_allclose(t.numpy(), w, **LOGITS)
    step = ref_engine.jitted_decode_step(cfg_ref)
    for t in range(3):
        nxt = np.argmax(np.asarray(want)[:, -1, :cfg.vocab_size], -1)
        assert np.array_equal(nxt, got[:, -1, :cfg.vocab_size]
                              .argmax(-1).numpy())
        want, wstate = step(params_ref, state=wstate,
                            tokens=jnp.asarray(nxt[:, None]))
        got, state = lm.decode_step(params, cfg, state,
                                    torch.from_numpy(nxt[:, None]))
        assert state["pos"] == s + t + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_greedy_generate_matches_reference(model):
    arch, cfg_ref, cfg, params_ref, params = model
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8))
    sampling = SamplingConfig(max_new_tokens=12)
    want, _ = ref_engine.generate(params_ref, cfg_ref,
                                  {"tokens": jnp.asarray(tok)}, sampling)
    got, _ = generate(params, cfg, {"tokens": torch.from_numpy(tok)},
                      sampling)
    assert got.tolist() == np.asarray(want).tolist()


def test_paged_decode_matches_reference(model):
    """The fused paged step of both packages from the same prefill
    scatter: logits within 1e-4 for three steps, every recurrent row and
    K/V page within 1e-4."""
    arch, cfg_ref, cfg, params_ref, params = model
    from repro.serve import paged_cache as ref_pc
    from repro_torch.serve import paged_cache
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8))
    states = []
    for mod, c, p, pc, st_mod in (
            (ref_lm, cfg_ref, params_ref, ref_pc, jnp),
            (lm, cfg, params, paged_cache, torch)):
        kw = {} if mod is ref_lm else {"device": "cpu"}
        st = mod.init_paged_state(c, 2, 8, 4, 4, **kw)
        toks = (jnp.asarray(tok) if mod is ref_lm
                else torch.from_numpy(tok))
        _, pre = mod.prefill(p, c, {"tokens": toks}, max_seq=8)
        pages = [3, 5] if mod.needs_kv_pages(c) else []
        st = pc.scatter_prefill_state(st, pre, 1, pages, 4)
        table = np.zeros((2, 4), np.int32)
        table[1, :2] = pages if pages else 0
        table[1, 2] = 6 if pages else 0
        pos = np.array([0, 8], np.int32)
        st = dict(st, table=st_mod.asarray(table) if mod is ref_lm else
                  torch.from_numpy(table),
                  pos=st_mod.asarray(pos) if mod is ref_lm else
                  torch.from_numpy(pos))
        states.append(st)
    wstate, state = states
    nxt = np.array([[0], [7]])
    step = ref_engine.jitted_decode_step(cfg_ref, paged=True)
    for _ in range(3):
        want, wstate = step(params_ref, state=wstate,
                            tokens=jnp.asarray(nxt))
        got, state = lm.decode_step_paged(params, cfg, state,
                                          torch.from_numpy(nxt))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want)[1],
                                   **LOGITS)
        nxt = np.argmax(np.asarray(want)[:, -1, :cfg.vocab_size],
                        -1)[:, None]
    for key in ("groups", "tail"):
        for bkey, cache in state.get(key, {}).items():
            for name, t in cache.items():
                w = np.asarray(wstate[key][bkey][name])
                rows = (slice(None), [3, 5, 6]) if name in ("k", "v") \
                    else (slice(None), 1)
                np.testing.assert_allclose(t.numpy()[rows], w[rows],
                                           **LOGITS)


def test_rolling_window_cache_wraps():
    """The reference's case: decode to 3× the window (S 48, window 16);
    each step's logits within 1e-4 of the reference's decode and within
    the reference test's tolerance of its full forward."""
    cfg_ref = ref_smoke_config("recurrentgemma-9b")
    cfg = get_smoke_config("recurrentgemma-9b")
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(1))
    params = params_from_numpy(flatten_ref(params_ref), cfg, device="cpu")
    s = 48
    tok = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, s), 0,
                                        cfg.vocab_size))
    full = jax.jit(lambda p, t: ref_lm.forward(p, cfg_ref, {"tokens": t},
                                               remat=False))(
        params_ref, jnp.asarray(tok))
    _, wstate = ref_engine.jitted_prefill(cfg_ref, s + 8)(
        params_ref, batch={"tokens": jnp.asarray(tok[:, :s - 8])})
    _, state = lm.prefill(params, cfg,
                          {"tokens": torch.from_numpy(tok[:, :s - 8])},
                          max_seq=s + 8)
    assert state["groups"]["b2"]["k"].shape[2] == cfg.window
    step = ref_engine.jitted_decode_step(cfg_ref)
    for t in range(8):
        nt = tok[:, s - 8 + t][:, None]
        want, wstate = step(params_ref, state=wstate, tokens=jnp.asarray(nt))
        got, state = lm.decode_step(params, cfg, state, torch.from_numpy(nt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   np.asarray(full[:, s - 8 + t]),
                                   rtol=2e-2, atol=2e-3)


# --------------------------------------------------------------------------
# the converter, the entry points and what stays refused
# --------------------------------------------------------------------------

def test_params_from_numpy_carries_the_tail(model):
    arch, cfg_ref, cfg, params_ref, params = model
    tree = flatten_ref(params_ref)
    _, _, tail = cfg.layer_plan()
    if not tail:
        assert "tail" not in params
        return
    assert set(params["tail"]) == {"b0"}
    for name in ("lru_input", "lambda", "conv"):
        got = params["tail"]["b0"]["rglru"][name]
        assert got.shape[0] == len(tail)
        assert np.array_equal(got.numpy(), tree["tail"]["b0"]["rglru"][name])
    assert set(params["groups"]) == {"b0", "b1", "b2"}
    bad = dict(tree, tail={"b0": dict(tree["tail"]["b0"], norm1={
        "scale": tree["tail"]["b0"]["norm1"]["scale"][:1]})})
    with pytest.raises(ValueError, match="/tail/b0/norm1/scale"):
        params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="tail"):
        params_from_numpy({k: v for k, v in tree.items() if k != "tail"},
                          cfg, device="cpu")


def test_init_params_has_the_reference_layout(model):
    arch, cfg_ref, cfg, params_ref, _ = model
    got = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree, fn):
        return {k: shapes(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    assert shapes(got, lambda t: tuple(t.shape)) == \
        shapes(params_ref, lambda a: tuple(a.shape))
    state = lm.init_decode_state(cfg, 2, 40, device="cpu")
    want = ref_lm.init_decode_state(cfg_ref, 2, 40)
    assert shapes({k: v for k, v in state.items() if k != "pos"},
                  lambda t: tuple(t.shape)) == \
        shapes({k: v for k, v in want.items() if k != "pos"},
               lambda a: tuple(a.shape))


def test_sparse_mlp_layers_share_one_pattern():
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              sparse_mlp=True, sparse_block=(8, 8))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    weights = [params[key][b]["mlp"]["w_down"]
               for key in ("groups", "tail") for b in params[key]]
    assert len(weights) == 4
    for w in weights[1:]:
        assert np.array_equal(w.block_col, weights[0].block_col)
        assert np.array_equal(w.row_ptr, weights[0].row_ptr)
    assert lm.sparse_mlp_plan(params) is not None


def test_training_the_recurrent_families_stays_refused(model):
    """Both recurrent families train now: the hybrid family's local
    attention through ``chunked_attention`` (a sequence of 64 against its
    window of 16), the SSM's scan through autograd; the loss equals the
    reference's (``test_torch_train_families`` holds the gradients)."""
    arch, cfg_ref, cfg, params_ref, params = model
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 65))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}         # two chunks
    want, _ = jax.jit(lambda p: ref_lm.loss_fn(p, cfg_ref, {
        k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}))(
        params_ref)
    got, _ = lm.loss_fn(lm.unstack_layers(params), cfg, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_cli_runs_the_recurrent_families_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    tokens = main(["--arch", arch, "--smoke", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    assert tokens.shape == (2, 3) and "on cpu" in capsys.readouterr().out


def test_encoder_decoder_and_vision_models_stay_refused():
    """What stays refused of the encoder-decoder and vision-prefix
    families: a recurrent (hybrid or SSM) pattern with an encoder or a
    vision prefix, under its own family or theirs; paged decode with
    cross caches or a prefix.  Training the audio and vlm families, once
    refused too, runs now: the loss equals the reference's."""
    for arch in RECURRENT:
        cfg = get_smoke_config(arch)
        for bad in (dict(n_enc_layers=2), dict(n_patches=8),
                    dict(family="audio", n_enc_layers=2),
                    dict(family="vlm", n_patches=8), dict(family="vlm"),
                    dict(family="audio")):
            with pytest.raises(NotImplementedError, match="not ported"):
                lm.init_params(dataclasses.replace(cfg, **bad),
                               torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        lm.init_params(dataclasses.replace(
            get_smoke_config("recurrentgemma-9b"), family="ssm"),
            torch.Generator(), device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 512, (1, 5))
    for arch in ("whisper-base", "internvl2-1b"):
        cfg_ref, cfg = ref_smoke_config(arch), get_smoke_config(arch)
        params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
        params = params_from_numpy(flatten_ref(params_ref), cfg,
                                   device="cpu")
        extra = ({"enc_frames": (1, cfg.enc_seq, cfg.d_model)}
                 if cfg.n_enc_layers else
                 {"vision_embeds": (1, cfg.n_patches, cfg.d_model)})
        batch = {"tokens": tok[:, :4], "labels": tok[:, 1:],
                 **{k: rng.standard_normal(shape).astype(np.float32)
                    for k, shape in extra.items()}}
        want, _ = jax.jit(lambda p: ref_lm.loss_fn(p, cfg_ref, {
            k: jnp.asarray(v) for k, v in batch.items()}))(params_ref)
        got, _ = lm.loss_fn(lm.unstack_layers(params), cfg,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        with pytest.raises(NotImplementedError, match="paged decode"):
            lm.init_paged_state(cfg, 2, 8, 4, 4, device="cpu")
