"""Port parity: ``repro_torch.models.ssm`` (Mamba-2 SSD) against
``repro.models.ssm`` at f32 tolerance 1e-5.  Parameters come from the
reference's ``init_ssm``; inputs are numpy arrays made from a seed and fed
to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RS
from repro_torch.models import ssm as S

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = dict(d_model=32, d_state=16, headdim=8, chunk=8)
REF_CFG = RS.SSMConfig(**FIELDS)
CFG = S.SSMConfig(**FIELDS)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def params():
    ref = RS.init_ssm(jax.random.PRNGKey(0), REF_CFG)
    # non-trivial skip, bias and norm, so each term is held
    ref = dict(ref, d_skip=jnp.asarray(_rand(1, CFG.n_heads)),
               dt_bias=jnp.asarray(_rand(2, CFG.n_heads, scale=0.5)),
               norm={"scale": jnp.asarray(_rand(3, CFG.d_inner, scale=0.1))})
    return ref, _to(ref, lambda v: torch.from_numpy(np.array(v)))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_config_and_init_match_reference():
    assert (CFG.d_inner, CFG.n_heads) == (REF_CFG.d_inner, REF_CFG.n_heads)
    ref = RS.init_ssm(jax.random.PRNGKey(1), REF_CFG)
    got = S.init_ssm(torch.Generator().manual_seed(1), CFG, stack=(2,))
    assert set(got) == set(ref)
    for k in ("in_proj", "conv", "out_proj"):
        assert tuple(got[k].shape) == (2, *ref[k].shape), k
    for k in ("a_log", "d_skip", "dt_bias"):       # the fixed values
        for layer in got[k]:
            np.testing.assert_allclose(layer.numpy(), np.asarray(ref[k]),
                                       rtol=1e-6)
    assert not got["norm"]["scale"].any()
    for g, w in zip(S.init_ssm_state(CFG, 3), RS.init_ssm_state(REF_CFG, 3)):
        assert tuple(g.shape) == w.shape and not g.any()


def test_segsum_matches_reference():
    x = _rand(4, 2, 3, 9)
    got = S._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(RS._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def test_segsum_sums_each_segment_apart():
    """At a full-size chunk (256) the log-decays sum to about -1 300.  The
    reference's difference of two running sums then keeps few of f32's
    bits; the port sums each segment apart.  On the segments that decay
    to more than e^-30 (the weights that count) the port stays within
    1e-5 of the float64 sums, where the reference is over 10× further
    off."""
    x = -np.random.default_rng(9).uniform(0, 10, (4, 256)).astype(np.float32)
    csum = np.cumsum(x.astype(np.float64), -1)
    truth = csum[..., :, None] - csum[..., None, :]
    live = np.tril(np.ones((256, 256), bool)) & (truth > -30)
    port = S._segsum(torch.from_numpy(x)).numpy()
    ref = np.asarray(RS._segsum(jnp.asarray(x)))
    port_err = np.abs(port - truth)[live].max()
    assert port_err <= 1e-5
    assert np.abs(ref - truth)[live].max() > 10 * port_err


def _scan_inputs(seed, b, s):
    h, p, n = CFG.n_heads, CFG.headdim, CFG.d_state
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32),
            np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 16), (5, 5), (16, 16)])
def test_ssd_scan_matches_reference(s, chunk):
    args = _scan_inputs(s + chunk, 2, s)
    y, st = S.ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
    ref_y, ref_st = RS.ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    _close(y, ref_y)
    _close(st, ref_st)


def test_ragged_sequences_are_refused_as_in_the_reference(params):
    args = _scan_inputs(0, 1, 12)
    with pytest.raises(ValueError, match="not divisible"):
        RS.ssd_scan(*map(jnp.asarray, args), chunk=8)
    with pytest.raises(ValueError, match="not divisible"):
        S.ssd_scan(*map(torch.from_numpy, args), chunk=8)
    with pytest.raises(ValueError, match="not divisible"):
        S.ssm_block(params[1], CFG, torch.from_numpy(_rand(5, 1, 12, 32)))


@pytest.mark.parametrize("decode", [False, True])
def test_causal_conv_matches_reference(decode):
    x, w = _rand(6, 2, 1 if decode else 7, 12), _rand(7, 4, 12)
    state = _rand(8, 2, 3, 12) if decode else None
    got = S._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                         None if state is None else torch.from_numpy(state))
    want = RS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                           None if state is None else jnp.asarray(state))
    for g, v in zip(got, want):
        _close(g, v)


@pytest.mark.parametrize("s", [5, 8, 24])
def test_block_with_state_matches_reference(params, s):
    ref, p = params
    x = _rand(10 + s, 2, s, FIELDS["d_model"])
    out, (conv, st) = S.ssm_block(p, CFG, torch.from_numpy(x),
                                  return_state=True)
    ref_out, (ref_conv, ref_st) = RS.ssm_block(ref, REF_CFG, jnp.asarray(x),
                                               return_state=True)
    _close(out, ref_out)
    _close(conv, ref_conv)
    _close(st, ref_st)


def test_decode_step_matches_reference(params):
    ref, p = params
    di2n = CFG.d_inner + 2 * CFG.d_state
    x, conv = _rand(20, 2, 1, FIELDS["d_model"]), _rand(21, 2, 3, di2n)
    st = _rand(22, 2, CFG.n_heads, CFG.headdim, CFG.d_state)
    got = S.ssm_decode_step(p, CFG, *map(torch.from_numpy, (x, conv, st)))
    want = RS.ssm_decode_step(ref, REF_CFG, *map(jnp.asarray, (x, conv, st)))
    for g, w in zip(got, want):
        _close(g, w)


def test_decode_chain_equals_the_block(params):
    """Decoding token by token from the zero state reproduces the chunked
    block over three chunks: outputs and the final state."""
    _, p = params
    x = torch.from_numpy(_rand(30, 2, 24, FIELDS["d_model"]))
    out, (conv_want, st_want) = S.ssm_block(p, CFG, x, return_state=True)
    conv, st = S.init_ssm_state(CFG, 2)
    steps = []
    for t in range(x.shape[1]):
        y, conv, st = S.ssm_decode_step(p, CFG, x[:, t:t + 1], conv, st)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), out.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(conv.numpy(), conv_want.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), st_want.numpy(), **TOL)


def test_short_sequence_is_one_chunk(params):
    """S < cfg.chunk runs as one chunk of S, as in the reference."""
    _, p = params
    x = torch.from_numpy(_rand(40, 1, 6, FIELDS["d_model"]))
    wide = dataclasses.replace(CFG, chunk=64)
    assert torch.equal(S.ssm_block(p, wide, x), S.ssm_block(
        p, dataclasses.replace(CFG, chunk=6), x))
