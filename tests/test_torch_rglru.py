"""Port parity: ``repro_torch.models.rglru`` against ``repro.models.rglru``
at f32 tolerance 1e-5.  Parameters come from the reference's
``init_rglru``; inputs are numpy arrays made from a seed and fed to both
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as RR
from repro_torch.models import rglru as R

TOL = dict(rtol=1e-5, atol=1e-5)
D, W = 32, 48
REF_CFG = RR.RGLRUConfig(d_model=D, lru_width=W)
CFG = R.RGLRUConfig(d_model=D, lru_width=W)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def params():
    ref = RR.init_rglru(jax.random.PRNGKey(0), REF_CFG)
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_config_and_init_match_reference():
    assert CFG.conv_width == REF_CFG.conv_width == 4
    assert CFG.c_exponent == REF_CFG.c_exponent
    ref = RR.init_rglru(jax.random.PRNGKey(1), REF_CFG)
    got = R.init_rglru(torch.Generator().manual_seed(1), CFG, stack=(3,))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == (3, *v.shape), k
        assert got[k].dtype == torch.float32
    # a = sigmoid(Λ)^c spread over (0.9, 0.999), as the reference draws it
    a = torch.sigmoid(got["lambda"]) ** CFG.c_exponent
    assert bool(((a > 0.9 - 1e-5) & (a < 0.999 + 1e-5)).all())
    conv, h = R.init_rglru_state(CFG, 2)
    ref_conv, ref_h = RR.init_rglru_state(REF_CFG, 2)
    assert tuple(conv.shape) == ref_conv.shape and not conv.any()
    assert tuple(h.shape) == ref_h.shape and h.dtype == torch.float32


def test_gates_match_reference(params):
    ref, p = params
    x = _rand(2, 2, 5, W)
    la, g = R._rg_lru_gates(p, CFG, torch.from_numpy(x))
    ref_la, ref_g = RR._rg_lru_gates(ref, REF_CFG, jnp.asarray(x))
    assert la.dtype == g.dtype == torch.float32
    _close(la, ref_la)
    _close(g, ref_g)


@pytest.mark.parametrize("s", [1, 5, 24, 37])
def test_scan_matches_reference(s):
    rng = np.random.default_rng(s)
    log_a = -rng.uniform(0.0, 0.5, (2, s, W)).astype(np.float32)
    gated = rng.standard_normal((2, s, W)).astype(np.float32)
    got = R.rg_lru_scan(torch.from_numpy(log_a), torch.from_numpy(gated))
    _close(got, RR.rg_lru_scan(jnp.asarray(log_a), jnp.asarray(gated)))
    # against the recurrence itself, step by step
    h, want = np.zeros((2, W), np.float64), []
    for t in range(s):
        h = np.exp(log_a[:, t]) * h + gated[:, t]
        want.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), **TOL)


@pytest.mark.parametrize("s", [1, 5, 24, 37])
def test_block_with_state_matches_reference(params, s):
    ref, p = params
    x = _rand(10 + s, 2, s, D)
    out, (conv, h) = R.rglru_block(p, CFG, torch.from_numpy(x),
                                   return_state=True)
    ref_out, (ref_conv, ref_h) = RR.rglru_block(ref, REF_CFG, jnp.asarray(x),
                                                return_state=True)
    _close(out, ref_out)
    _close(conv, ref_conv)
    _close(h, ref_h)
    assert torch.equal(R.rglru_block(p, CFG, torch.from_numpy(x)), out)


def test_decode_step_matches_reference(params):
    ref, p = params
    x, conv, h = _rand(20, 2, 1, D), _rand(21, 2, 3, W), _rand(22, 2, W)
    got = R.rglru_decode_step(p, CFG, *map(torch.from_numpy, (x, conv, h)))
    want = RR.rglru_decode_step(ref, REF_CFG, *map(jnp.asarray, (x, conv, h)))
    for g, w in zip(got, want):
        _close(g, w)


def test_decode_chain_equals_the_block(params):
    """Decoding token by token from the zero state reproduces the
    full-sequence block, outputs and final state."""
    _, p = params
    x = torch.from_numpy(_rand(30, 2, 13, D))
    out, (conv_want, h_want) = R.rglru_block(p, CFG, x, return_state=True)
    conv, h = R.init_rglru_state(CFG, 2)
    steps = []
    for t in range(x.shape[1]):
        y, conv, h = R.rglru_decode_step(p, CFG, x[:, t:t + 1], conv, h)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), out.numpy(),
                               **TOL)
    np.testing.assert_allclose(conv.numpy(), conv_want.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_want.numpy(), **TOL)
