"""Port parity: ``repro_torch.models.layers.chunked_attention`` (flash
attention with a hand-written backward) against the reference's
``chunked_attention`` and its custom VJP (``jax.vjp``) on the CPU, and the
layers that call it (``attention``, ``attention_prefill`` on global
attention, ``cross_attention``) against theirs.

The reference takes K/V repeated over the head groups and chunks that
divide the lengths; the port takes the KV heads as they are (head ``h``
reads kv head ``h // G``) and any chunks, the last kv tile short.  So the
reference's dK / dV are summed over each group's heads before the
comparison, and each case runs the two packages at different chunks.

Tolerances (f32): the forward within 1e-5; dQ, dK and dV within
1e-5·max|ref| + 1e-6 (the same sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as L

FWD = 1e-5

# case: (B, Sq, Sk, H, KVH, hd, causal, window, q_offset, the port's
# (q_chunk, kv_chunk), the reference's (q_chunk, kv_chunk))
CASES = {
    "causal": (2, 48, 48, 4, 4, 16, True, None, 0, (16, 16), (16, 16)),
    "non_causal": (2, 40, 56, 4, 2, 16, False, None, 0, (16, 16), (8, 8)),
    "window_below_s": (2, 48, 48, 4, 1, 16, True, 12, 0, (8, 16), (16, 16)),
    "window_above_s": (2, 48, 48, 4, 1, 16, True, 64, 0, (16, 16),
                       (16, 16)),
    "q_offset": (1, 24, 56, 4, 2, 16, True, None, 32, (8, 16), (8, 8)),
    "q_offset_window": (1, 24, 56, 4, 2, 16, True, 20, 32, (8, 16), (8, 8)),
    "gqa_ragged": (2, 37, 37, 8, 2, 16, True, None, 0, (8, 16), (37, 37)),
    "window_ragged": (1, 45, 45, 4, 1, 16, True, 10, 0, (16, 32), (45, 45)),
    "non_causal_window": (1, 33, 33, 4, 2, 8, False, 6, 0, (8, 8),
                          (33, 33)),
    "one_tile": (2, 30, 30, 4, 2, 16, True, None, 0, (512, 1024),
                 (30, 30)),
}


def _inputs(seed, b, sq, sk, h, kvh, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    return q, k, v, dout


def _reference(q, k, v, dout, causal, window, q_offset, chunks):
    """The reference's output and (dQ, dK, dV) by ``jax.vjp``, dK / dV
    summed over each group's heads (the gradient of the repeat)."""
    h, kvh = q.shape[2], k.shape[2]
    rep = lambda t: jnp.repeat(jnp.asarray(t), h // kvh, axis=2)
    out, vjp = jax.vjp(lambda q, k, v: RL.chunked_attention(
        q, rep(k), rep(v), causal, window, *chunks, q_offset),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out), *(np.asarray(g) for g in
                               vjp(jnp.asarray(dout))))


def _port(q, k, v, dout, causal, window, q_offset, chunks):
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = L.chunked_attention(tq, tk, tv, causal, window, *chunks, q_offset)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    return (out.detach().numpy(), *(g.numpy() for g in grads))


def _assert_grads(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, (what, name)
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()) + 1e-6, (what, name, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_reference(case):
    b, sq, sk, h, kvh, hd, causal, window, off, port_c, ref_c = CASES[case]
    q, k, v, dout = _inputs(len(case), b, sq, sk, h, kvh, hd)
    want = _reference(q, k, v, dout, causal, window, off, ref_c)
    got = _port(q, k, v, dout, causal, window, off, port_c)
    assert got[0].shape == want[0].shape
    assert float(np.abs(got[0] - want[0]).max()) <= FWD, case
    _assert_grads(got[1:], want[1:], case)


def _count_tiles(monkeypatch):
    calls = {"forward": 0, "backward": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(L, "_forward_tile",
                        counting("forward", L._forward_tile))
    monkeypatch.setattr(L, "_backward_tile",
                        counting("backward", L._backward_tile))
    return calls


@pytest.mark.parametrize("chunks,steps", [((64, 128), 5), ((512, 1024), 1)])
def test_prime_length_runs_one_step_a_kv_chunk(monkeypatch, chunks, steps):
    """At S = 521 (prime) the reference's chunk choice is a q chunk of 1
    (521 q chunks; a kv chunk of 64 would give 521 kv steps); the port
    runs ⌈S / kv_chunk⌉ loop steps each way, and still computes the
    reference's function (here held at one whole tile)."""
    s = 521
    q, k, v, dout = _inputs(7, 1, s, s, 2, 1, 16)
    assert RL.largest_divisor_leq(s, 512) == RL.largest_divisor_leq(
        s, 128) == 1
    calls = _count_tiles(monkeypatch)
    got = _port(q, k, v, dout, True, None, 0, chunks)
    assert calls == {"forward": -(-s // chunks[1]),
                     "backward": -(-s // chunks[1])} == \
        {"forward": steps, "backward": steps}
    want = _reference(q, k, v, dout, True, None, 0, (s, s))
    assert float(np.abs(got[0] - want[0]).max()) <= FWD
    _assert_grads(got[1:], want[1:], "prime")


def test_tiles_no_row_sees_are_left_out(monkeypatch):
    """A window that ends before a kv tile's rows begin leaves the tile
    out; the result is still the reference's."""
    s, window = 64, 8
    tiles = L._tiles(s, s, True, window, 8, 8, 0)
    assert [(t.k0, t.k1) for t in tiles] == [(k0, k0 + 8)
                                             for k0 in range(0, s, 8)]
    # every kv tile is seen by its own q tile and the next only
    assert [(t.r0, t.r1) for t in tiles] == [(k0, min(k0 + 16, s))
                                             for k0 in range(0, s, 8)]
    # a query offset past every key but the last tile's window
    late = L._tiles(8, 64, True, window, 8, 8, 56)
    assert [(t.k0, t.r0, t.r1) for t in late] == [(48, 0, 8), (56, 0, 8)]
    q, k, v, dout = _inputs(3, 1, 8, 64, 2, 2, 16)
    calls = _count_tiles(monkeypatch)
    got = _port(q, k, v, dout, True, window, 56, (8, 8))
    assert calls == {"forward": 2, "backward": 2}
    want = _reference(q, k, v, dout, True, window, 56, (8, 8))
    assert float(np.abs(got[0] - want[0]).max()) <= FWD
    _assert_grads(got[1:], want[1:], "late")


def test_full_tiles_take_no_mask():
    # a causal tile's rows run from the diagonal on: it takes the mask
    assert not any(t.full for t in L._tiles(64, 64, True, None, 16, 16, 0))
    assert all(t.full for t in L._tiles(40, 56, False, None, 8, 8, 0))
    # queries after every key, within the window: no mask either
    assert all(t.full for t in L._tiles(8, 64, True, None, 8, 16, 64))
    assert all(t.full for t in L._tiles(8, 64, True, 80, 8, 16, 64))
    assert not any(t.full for t in L._tiles(8, 64, True, 70, 8, 16, 64)[:1])


def test_one_tile_shortcut_equals_the_running_update():
    """A call of one tile over every row takes the tile's own (max, sum,
    output); they equal the running update from (-inf, 0, 0) bit for
    bit."""
    q, k, v, _ = _inputs(9, 2, 37, 37, 8, 2, 16)
    q, k, v = (torch.from_numpy(t) for t in (q, k, v))
    t, = L._tiles(37, 37, True, None, 512, 1024, 0)
    assert (t.r0, t.r1, t.k0, t.k1, t.full) == (0, 37, 0, 37, False)
    qs = L._rows(q, 2) * 0.25
    k32, v32 = (x.transpose(1, 2).contiguous() for x in (k, v))
    args = (slice(0, 37 * 4), slice(0, 37), qs, k32, v32,
            L._tile_hidden(t, True, None, 0, "cpu"), 4)
    run = (torch.full(qs.shape[:3], float("-inf")),
           torch.zeros(qs.shape[:3]), torch.zeros_like(qs))
    for a, b in zip(L._forward_tile(*args), L._forward_tile(*args, run)):
        assert torch.equal(a, b)


def test_reruns_are_bit_identical():
    q, k, v, dout = _inputs(11, 2, 45, 45, 8, 2, 16)
    runs = [_port(q, k, v, dout, True, 20, 0, (16, 16)) for _ in range(2)]
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


def test_rows_with_no_key_give_zero_and_the_reference_lse():
    """A query row that sees no key (causal, its position before every
    key) gets a zero output and zero gradients, as the reference's
    ``-inf`` handling gives."""
    q, k, v, dout = _inputs(5, 1, 8, 8, 2, 2, 8)
    got = _port(q, k, v, dout, True, None, -4, (4, 4))
    want = _reference(q, k, v, dout, True, None, -4, (4, 4))
    assert not got[0][:, :4].any()
    assert float(np.abs(got[0] - want[0]).max()) <= FWD
    _assert_grads(got[1:], want[1:], "no key")


def test_bf16_inputs_keep_their_dtype():
    q, k, v, dout = _inputs(2, 1, 24, 24, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(t).bfloat16().requires_grad_()
                  for t in (q, k, v))
    out = L.chunked_attention(tq, tk, tv, True, None, 8, 8)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(dout).bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in grads)
    want = _port(*(t.detach().float().numpy() for t in (tq, tk, tv)),
                 dout, True, None, 0, (8, 8))
    assert float((out.float() - torch.from_numpy(want[0])).abs().max()) \
        <= 1e-2 * float(np.abs(want[0]).max())


def test_mismatched_heads_raise():
    q = torch.zeros((1, 4, 6, 8))
    with pytest.raises(ValueError, match="KVH"):
        L.chunked_attention(q, torch.zeros((1, 4, 4, 8)),
                            torch.zeros((1, 4, 4, 8)))


# --------------------------------------------------------------------------
# the layers on it
# --------------------------------------------------------------------------

D, H, KVH, HD = 32, 4, 2, 8


def _attn(seed, bias, **kw):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (D, H, HD), "wk": (D, KVH, HD), "wv": (D, KVH, HD),
              "wo": (H, HD, D)}
    p = {n: (rng.standard_normal(s) * D ** -0.5).astype(np.float32)
         for n, s in shapes.items()}
    if bias:
        for n, heads in (("bq", H), ("bk", KVH), ("bv", KVH)):
            p[n] = (rng.standard_normal((heads, HD)) * 0.1).astype(
                np.float32)
    cfg = dict(d_model=D, n_heads=H, n_kv_heads=KVH, head_dim=HD,
               qkv_bias=bias, **kw)
    return (RL.AttnConfig(**cfg), L.AttnConfig(**cfg),
            {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(seed, b, s):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(
        np.float32)


LAYER_CASES = {"global": dict(), "window": dict(window=8),
               "encoder": dict(causal=False)}


@pytest.mark.parametrize("kind", sorted(LAYER_CASES))
def test_attention_and_its_gradients_match_reference(kind):
    """``attention`` (the training route of every mask) and the gradient
    of its output's weighted sum in x and every weight, against
    ``jax.grad`` of the reference's ``attention``."""
    ref_cfg, cfg, pj, pt = _attn(1, True, **LAYER_CASES[kind])
    x = _x(2, 2, 21)
    pos = np.broadcast_to(np.arange(21), (2, 21)).copy()
    w = _x(3, 2, 21)
    want = RL.attention(pj, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    gx_want, gp_want = jax.grad(lambda x, p: jnp.sum(RL.attention(
        p, ref_cfg, x, jnp.asarray(pos)) * w), argnums=(0, 1))(
        jnp.asarray(x), pj)
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in pt.items()}
    got = L.attention(pt, cfg, xt, torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for name, g, ref in [("x", xt.grad, gx_want)] + [
            (k, pt[k].grad, gp_want[k]) for k in pt]:
        ref = np.asarray(ref)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max()) + 1e-6, (kind, name)


@pytest.mark.parametrize("cache", ["above", "equal"])
def test_global_attention_prefill_matches_reference(cache):
    ref_cfg, cfg, pj, pt = _attn(4, True, qk_norm=False)
    s = 27
    cache_len = s + 5 if cache == "above" else s
    x = _x(5, 2, s)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    want = RL.attention_prefill(pj, ref_cfg, jnp.asarray(x), jnp.asarray(pos),
                                cache_len=cache_len)
    got = L.attention_prefill(pt, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), cache_len=cache_len)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("sq", [1, 19])
def test_cross_attention_and_its_gradients_match_reference(sq):
    ref_cfg, cfg, pj, pt = _attn(6, True, causal=False)
    rng = np.random.default_rng(sq)
    x = _x(7, 2, sq)
    ek, ev = (rng.standard_normal((2, 41, KVH, HD)).astype(np.float32)
              for _ in range(2))
    want, vjp = jax.vjp(lambda x, k, v: RL.cross_attention(
        pj, ref_cfg, x, k, v), jnp.asarray(x), jnp.asarray(ek),
        jnp.asarray(ev))
    dy = rng.standard_normal(want.shape).astype(np.float32)
    wants = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, ek, ev)]
    got = L.cross_attention(pt, cfg, *ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(dy))
    for g, w in zip(grads, wants):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= \
            1e-5 * float(np.abs(w).max()) + 1e-6
