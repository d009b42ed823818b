"""Port parity: the compiled serving steps (``serve.jitted_prefill``,
``serve.jitted_decode_step``) and the decode step at a position held in a
device tensor, on the CPU.

* Both callables are cached on the reference's keys: a second call
  returns the same object, and ``generate`` / ``complete_static`` /
  ``ContinuousBatcher`` go through them.
* ``lm.decode_step`` (and ``attention_decode``) with ``pos`` a 0-dim
  tensor equals the int ``pos`` bit for bit: qwen3-4b, recurrentgemma-9b
  past its window (the rolling cache) and whisper-base (cross-attention)
  smoke configs.  That is what a captured step replays on the card.
* The callables over 4 greedy steps, static and paged, ``return_hidden``
  both ways, against the reference's ``jitted_decode_step`` on the same
  numpy weights: within 1e-5, greedy tokens equal.  On the CPU they run
  the eager step; nothing is captured.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.serve import engine as ref_engine
from repro.serve import paged_cache as ref_pc
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import (BatcherConfig, ContinuousBatcher, Request,
                               RequestQueue, SamplingConfig, complete_static,
                               engine, generate, jitted_decode_step,
                               jitted_prefill, paged_cache)
from test_torch_serve import flatten_ref

TOL = dict(rtol=1e-5, atol=1e-5)
SPARSE = dict(sparse_mlp=True, sparse_block=(8, 8))


def _models(arch, **over):
    cfg_ref = dataclasses.replace(ref_smoke_config(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    return cfg_ref, cfg, params_ref, params_from_numpy(
        flatten_ref(params_ref), cfg, device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _models("qwen3-4b", **SPARSE)


# --------------------------------------------------------------------------
# the cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("return_hidden", [False, True])
def test_decode_callables_are_cached_on_the_reference_key(paged,
                                                          return_hidden):
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), **SPARSE)
    fn = jitted_decode_step(cfg, paged=paged, return_hidden=return_hidden)
    again = jitted_decode_step(dataclasses.replace(cfg),
                               paged=int(paged),
                               return_hidden=int(return_hidden))
    assert again is fn
    assert (fn.paged, fn.return_hidden) == (paged, return_hidden)
    others = {jitted_decode_step(cfg, paged=p, return_hidden=r)
              for p in (False, True) for r in (False, True)}
    assert len(others) == 4 and fn in others
    assert jitted_decode_step(get_smoke_config("qwen3-4b"), paged=paged,
                              return_hidden=return_hidden) is not fn


def test_prefill_callables_are_cached_on_the_reference_key():
    cfg = get_smoke_config("qwen3-4b")
    fn = jitted_prefill(cfg, 11)
    assert jitted_prefill(dataclasses.replace(cfg), np.int64(11)) is fn
    assert jitted_prefill(cfg, 11, return_hidden=True) is not fn
    assert jitted_prefill(cfg, 12) is not fn
    assert (fn.max_seq, fn.return_hidden) == (11, False)


def _counting(monkeypatch, cls, calls, method="__call__"):
    """Record in ``calls`` each object whose ``method`` is called."""
    orig = getattr(cls, method)

    def call(self, *args, **kwargs):
        calls.append(self)
        return orig(self, *args, **kwargs)
    monkeypatch.setattr(cls, method, call)


def test_generate_reuses_one_pair_of_callables(qwen, monkeypatch):
    """As the reference's ``test_generate_jit_callables_cached``: two
    generate calls go through the same cached prefill and decode step,
    and on the CPU the step is never captured."""
    _, cfg, _, params = qwen
    batch = {"tokens": torch.ones((2, 8), dtype=torch.long)}
    sampling = SamplingConfig(max_new_tokens=3)
    step_fn = jitted_decode_step(cfg)
    prefill_fn = jitted_prefill(cfg, 8 + 3)
    calls = []
    _counting(monkeypatch, engine.DecodeStep, calls)
    _counting(monkeypatch, engine.PrefillStep, calls)
    first = generate(params, cfg, batch, sampling)[0]
    second = generate(params, cfg, batch, sampling)[0]
    assert torch.equal(first, second)
    assert calls.count(prefill_fn) == 2 and calls.count(step_fn) == 6
    assert len(calls) == 8
    assert jitted_decode_step(cfg) is step_fn
    assert jitted_prefill(cfg, 8 + 3) is prefill_fn
    assert step_fn.graph.captures == 0 and step_fn.graph.replays == 0


def test_complete_static_and_the_batcher_use_the_callables(qwen,
                                                           monkeypatch):
    """``complete_static``: one prefill callable for (cfg, prompt + new),
    the hidden-state step with a head; the batcher: its admission prefill
    through ``jitted_prefill``, its fused step through the cached paged
    step (eager on the CPU)."""
    _, cfg, _, params = qwen
    calls = []
    _counting(monkeypatch, engine.DecodeStep, calls)
    _counting(monkeypatch, engine.PrefillStep, calls)
    toks, reason, _ = complete_static(params, cfg, [3, 4, 5], 4,
                                      sampling=SamplingConfig())
    assert reason == "length" and len(toks) == 4
    assert calls == [jitted_prefill(cfg, 7)] + [jitted_decode_step(cfg)] * 3
    calls.clear()
    eager = []
    _counting(monkeypatch, engine.DecodeStep, calls)
    _counting(monkeypatch, engine.DecodeStep, eager, "eager")
    queue = RequestQueue()
    queue.submit(Request(tokens=np.array([1, 2, 3], np.int32),
                         max_new_tokens=3, rid=0))
    eng = ContinuousBatcher(params, cfg, queue,
                            BatcherConfig(max_slots=2, page_size=4,
                                          n_pages=8, max_seq=16))
    eng.run()
    assert calls == [jitted_prefill(cfg, 4)]
    assert eager == [jitted_decode_step(cfg, paged=True)] * 2
    assert eng.graph.captures == 0


# --------------------------------------------------------------------------
# a position in a device tensor
# --------------------------------------------------------------------------

def _as_tensor_pos(state):
    return dict(state, pos=torch.tensor(state["pos"]))


def _states_equal(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        if isinstance(v, dict):
            _states_equal(v, want[k])
        elif k == "pos":
            assert int(v) == int(want[k])
        else:
            assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("arch,over,prompt,steps", [
    ("qwen3-4b", SPARSE, 9, 4),
    ("recurrentgemma-9b", SPARSE, 13, 6),     # window 16: past it
    ("whisper-base", {}, 7, 4)])
def test_decode_step_at_a_tensor_position_is_the_int_one(arch, over,
                                                          prompt, steps):
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, prompt),
                                     generator=gen)}
    if cfg.n_enc_layers:
        batch["enc_frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                          generator=gen)
    _, state = lm.prefill(params, cfg, batch, max_seq=prompt + steps)
    tensor = _as_tensor_pos({**state, **{
        k: {b: {n: t.clone() for n, t in c.items()} for b, c in v.items()}
        for k, v in state.items() if isinstance(v, dict)}})
    tok = batch["tokens"][:, -1:]
    for _ in range(steps):
        want, state = lm.decode_step(params, cfg, state, tok)
        got, tensor = lm.decode_step(params, cfg, tensor, tok)
        assert torch.equal(got, want)
        assert torch.is_tensor(tensor["pos"]) and tensor["pos"].dim() == 0
        assert isinstance(state["pos"], int)
        _states_equal(tensor, state)
        tok = want[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    if cfg.window:
        assert state["pos"] > cfg.window


@pytest.mark.parametrize("window,s_cache", [(None, 12), (4, 4), (6, 12)])
def test_attention_decode_at_a_tensor_position_is_the_int_one(window,
                                                              s_cache):
    """Global, rolling local-window (``S_cache == window``, wrapping) and
    a window over a longer cache."""
    d, h, kvh, hd = 32, 4, 2, 8
    cfg = L.AttnConfig(d_model=d, n_heads=h, n_kv_heads=kvh, head_dim=hd,
                       qk_norm=True, window=window)
    p = L.init_attention(torch.Generator().manual_seed(2), cfg)
    gen = torch.Generator().manual_seed(3)
    ck = torch.randn((2, s_cache, kvh, hd), generator=gen)
    cv = torch.randn((2, s_cache, kvh, hd), generator=gen)
    tk, tv = ck.clone(), cv.clone()
    for pos in range(3, 11):
        x = torch.randn((2, 1, d), generator=gen)
        want, _, _ = L.attention_decode(p, cfg, x, ck, cv, pos)
        got, _, _ = L.attention_decode(p, cfg, x, tk, tv, torch.tensor(pos))
        assert torch.equal(got, want)
        assert torch.equal(tk, ck) and torch.equal(tv, cv)


# --------------------------------------------------------------------------
# the callables against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("return_hidden", [False, True])
def test_static_decode_callable_matches_reference(qwen, return_hidden):
    cfg_ref, cfg, params_ref, params = qwen
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9))
    ref_out, ref_state = ref_engine.jitted_prefill(
        cfg_ref, 13, return_hidden=return_hidden)(
            params_ref, batch={"tokens": jnp.asarray(prompts, jnp.int32)})
    out, state = jitted_prefill(cfg, 13, return_hidden=return_hidden)(
        params, batch={"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    step_ref = ref_engine.jitted_decode_step(cfg_ref,
                                             return_hidden=return_hidden)
    step = jitted_decode_step(cfg, return_hidden=return_hidden)
    for t in range(4):
        score = (lambda o: o @ params["lm_head"].t()) if return_hidden \
            else (lambda o: o)
        tok = score(out)[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        want_tok = np.argmax(np.asarray(
            ref_out @ params_ref["lm_head"].T if return_hidden
            else ref_out)[:, -1, :cfg.vocab_size], -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), want_tok)
        ref_out, ref_state = step_ref(params_ref, state=ref_state,
                                      tokens=jnp.asarray(want_tok, jnp.int32))
        out, state = step(params, state=state, tokens=tok)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   err_msg=f"step {t}", **TOL)
        assert state["pos"] == int(ref_state["pos"]) == 10 + t
    assert step.graph.captures == 0


@pytest.mark.parametrize("return_hidden", [False, True])
def test_paged_decode_callable_matches_reference(qwen, return_hidden):
    """Three requests prefilled by each package into their pages, a free
    fourth slot, then 4 greedy fused steps through both callables."""
    cfg_ref, cfg, params_ref, params = qwen
    psize, n_pages, max_pages = 4, 16, 4
    lens = (5, 7, 3)
    slot_pages = ([3, 9, 1, 12], [7, 2, 11, 5], [8, 10, 13, 14])
    state_ref = ref_lm.init_paged_state(cfg_ref, 4, n_pages, psize,
                                        max_pages)
    state = lm.init_paged_state(cfg, 4, n_pages, psize, max_pages,
                                device="cpu")
    rng = np.random.default_rng(9)
    for slot, (n, pages) in enumerate(zip(lens, slot_pages)):
        prompt = rng.integers(0, cfg.vocab_size, (1, n))
        held = pages[:-(-n // psize)]
        _, pre_ref = ref_engine.jitted_prefill(cfg_ref, len(held) * psize)(
            params_ref, batch={"tokens": jnp.asarray(prompt, jnp.int32)})
        state_ref = ref_pc.scatter_prefill_state(state_ref, pre_ref, slot,
                                                 held, psize)
        _, pre = jitted_prefill(cfg, len(held) * psize)(
            params, batch={"tokens": torch.from_numpy(prompt)})
        paged_cache.scatter_prefill_state(state, pre, slot, held, psize)
    table = ref_pc.make_table(list(slot_pages) + [[]], max_pages)
    pos = np.array(list(lens) + [0], np.int32)
    state_ref = dict(state_ref, table=jnp.asarray(table),
                     pos=jnp.asarray(pos))
    state = dict(state, table=torch.from_numpy(table),
                 pos=torch.from_numpy(pos))
    step_ref = ref_engine.jitted_decode_step(cfg_ref, paged=True,
                                             return_hidden=return_hidden)
    step = jitted_decode_step(cfg, paged=True, return_hidden=return_hidden)
    tok = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    tok[3] = 0
    for t in range(4):
        want, state_ref = step_ref(params_ref, state=state_ref,
                                   tokens=jnp.asarray(tok))
        got, state = step(params, state=state, tokens=torch.from_numpy(tok))
        np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3],
                                   err_msg=f"fused step {t}", **TOL)
        assert torch.equal(state["pos"], torch.from_numpy(pos + t + 1))
        logits = got @ params["lm_head"].t() if return_hidden else got
        want_l = (np.asarray(want) @ np.asarray(params_ref["lm_head"]).T
                  if return_hidden else np.asarray(want))
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1).numpy()
        np.testing.assert_array_equal(
            nxt[:3], np.argmax(want_l[:3, -1, :cfg.vocab_size], -1))
        tok = np.concatenate([nxt[:3], [0]]).astype(np.int32)[:, None]
    assert step.graph.captures == 0
