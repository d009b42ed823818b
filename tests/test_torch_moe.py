"""Port parity: the MoE slice of ``repro_torch`` against ``repro``.

Same inputs, made from numpy seeds, go through both packages on the CPU:
the grouped GEMM entry point and its kernel wrapper (the reference's
Pallas kernel in interpret mode), the dense oracle, the MoE layer (routing
arrays exactly equal, outputs within the f32 tolerance) and the
granite-moe-3b smoke config end to end (weights initialised by the
reference and carried across with ``repro_torch.convert``).

Tolerances: f32 results within 1e-5·max|ref| + 1e-6 (the two sum in
different orders); bf16 within 1e-2·max|ref| (one bf16 rounding of an f32
sum, at most one ulp of 2^-8); model logits within 1e-4, the repo's f32
tolerance through a whole model; greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import moe_expert_gemm as ref_moe_expert_gemm
from repro.kernels.moe_gemm import moe_gemm_pallas
from repro.kernels.ref import moe_gemm_ref as ref_moe_gemm_ref
from repro.models import lm as ref_lm
from repro.models import moe as RM
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import moe_expert_gemm
from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_plain
from repro_torch.kernels.ops import expert_of_tile
from repro_torch.kernels.ref import moe_gemm_ref
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.serve import SamplingConfig, generate

TOL = dict(rtol=1e-4, atol=1e-4)
SWEEP = [[256, 0, 384, 128], [128, 128, 128, 128], [0, 0, 512, 0]]


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    limit = 1e-5 * scale + 1e-6 if dtype == "float32" else 1e-2 * scale
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= limit, f"max|port - ref| = {err} > {limit}"


def _pair(a, dtype):
    """A numpy f32 array as (jax, torch) operands of ``dtype``."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _flatten(tree):
    if isinstance(tree, dict):
        return {k: _flatten(v) for k, v in tree.items()}
    return np.asarray(tree)


# --------------------------------------------------------------------------
# the grouped GEMM (B8)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_expert_gemm_matches_reference(sizes, dtype):
    rng = np.random.default_rng(sum(sizes))
    e, d, f, bt = len(sizes), 256, 256, 128
    t = int(np.sum(sizes))
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32) * 0.1
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    gs = np.asarray(sizes, np.int32)
    ref = ref_moe_expert_gemm(jx, jnp.asarray(gs), jw, bt=bt)
    got = moe_expert_gemm(tx, torch.from_numpy(gs), tw, bt=bt)
    assert got.dtype == tx.dtype and got.shape == (t, f)
    _close(_np(got), ref, dtype)
    # the reference's tile -> expert arithmetic (ops.py, moe_expert_gemm)
    ref_eot = jnp.searchsorted(jnp.cumsum(jnp.asarray(gs)),
                               jnp.arange(t // bt, dtype=jnp.int32) * bt,
                               side="right").astype(jnp.int32)
    eot = expert_of_tile(torch.from_numpy(gs), t // bt, bt)
    assert eot.dtype == torch.int32
    np.testing.assert_array_equal(eot.numpy(), np.asarray(ref_eot))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,d,f,bt,tiles", [
    (8, 64, 32, 8, [0, 1, 1, 3, 5, 5, 7]),   # smoke widths, decode tile
    (3, 40, 24, 4, [2, 0, 2]),               # widths of no tiling multiple
    (4, 64, 96, 16, [3, 1])])                # w read for two experts only
def test_moe_gemm_wrapper_matches_pallas_kernel(dtype, e, d, f, bt, tiles):
    rng = np.random.default_rng(e * d + f)
    t = bt * len(tiles)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    eot = np.asarray(tiles, np.int32)
    ref = moe_gemm_pallas(jx, jnp.asarray(eot), jw, bt=bt, bf=f, bd=d,
                          interpret=True)
    before = moe_gemm.launches
    got = moe_gemm(tx, torch.from_numpy(eot), tw, bt=bt)
    assert moe_gemm.launches == before       # CPU: the plain version only
    _close(_np(got), ref, dtype)
    _close(_np(moe_gemm_ref(tx, torch.from_numpy(eot), tw, bt=bt)),
           ref_moe_gemm_ref(jx, jnp.asarray(eot), jw, bt=bt), dtype)


def test_moe_gemm_plain_is_the_dense_oracle():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((48, 20)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 20, 12)).astype(np.float32))
    eot = torch.tensor([4, 0, 0, 2, 1, 4], dtype=torch.int32)
    torch.testing.assert_close(moe_gemm_plain(x, eot, w, bt=8),
                               moe_gemm_ref(x, eot, w, bt=8),
                               rtol=1e-5, atol=1e-6)


def test_moe_gemm_refuses_bad_operands():
    x = torch.zeros((16, 8))
    w = torch.zeros((2, 8, 4))
    eot = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible"):
        moe_gemm(x, eot, w, bt=6)
    with pytest.raises(ValueError, match="D mismatch"):
        moe_gemm(x, eot, torch.zeros((2, 7, 4)), bt=8)
    with pytest.raises(ValueError, match="tiles"):
        moe_gemm(x, torch.zeros((3,), dtype=torch.int32), w, bt=8)
    with pytest.raises(TypeError, match="int32"):
        moe_gemm(x, eot.long(), w, bt=8)
    with pytest.raises(TypeError, match="bfloat16"):
        moe_gemm(x, eot, w.double(), bt=8)
    with pytest.raises(ValueError, match="not divisible"):
        moe_expert_gemm(x, torch.tensor([8, 8]), w, bt=5)


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------

def _ref_route(p, cfg, xt, cap):
    """The reference's routing (src/repro/models/moe.py, moe_layer)."""
    t, k = xt.shape[0], cfg.top_k
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    flat_e = expert_idx.reshape(-1).astype(jnp.int32)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, sorted_e, side="left")
    rank = jnp.arange(t * k, dtype=jnp.int32) - first.astype(jnp.int32)
    return {"expert_idx": expert_idx, "order": order, "sorted_e": sorted_e,
            "rank": rank, "keep": rank < cap}


MOE_CASES = {
    # the granite-moe-3b smoke config's layer
    "smoke": (dict(d_model=64, n_experts=8, n_experts_padded=8, top_k=2,
                   d_expert=32, capacity_factor=4.0), (2, 8)),
    # granite's routing (40 experts padded to 48, top-8, capacity factor
    # 1.25) at narrow widths, then with tokens dropped at capacity
    "padded": (dict(d_model=48, n_experts=40, n_experts_padded=48, top_k=8,
                    d_expert=24, capacity_factor=1.25), (2, 24)),
    "padded_drops": (dict(d_model=48, n_experts=40, n_experts_padded=48,
                          top_k=8, d_expert=24, capacity_factor=0.5),
                     (2, 24)),
    "tight": (dict(d_model=32, n_experts=8, n_experts_padded=8, top_k=2,
                   d_expert=16, capacity_factor=0.5), (4, 16)),
    "cf_zero": (dict(d_model=32, n_experts=4, n_experts_padded=6, top_k=2,
                     d_expert=16, capacity_factor=0.0), (3, 10)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_layer_matches_reference(case):
    fields, (b, s) = MOE_CASES[case]
    ref_cfg = RM.MoEConfig(**fields)
    cfg = M.MoEConfig(**fields)
    p_ref = RM.init_moe(jax.random.PRNGKey(len(case)), ref_cfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    x = np.random.default_rng(len(case)).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    cap = M._capacity(b * s, cfg)
    assert cap == RM._capacity(b * s, ref_cfg)
    want = _ref_route(p_ref, ref_cfg, jnp.asarray(x.reshape(b * s, -1)), cap)
    got = M.route(p["router"], cfg, torch.from_numpy(x.reshape(b * s, -1)),
                  cap)
    for key in ("expert_idx", "order", "sorted_e", "rank", "keep"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    if case in ("padded_drops", "tight", "cf_zero"):
        assert not bool(got["keep"].all())            # tokens are dropped
    y_ref, aux_ref = RM.moe_layer(p_ref, ref_cfg, jnp.asarray(x),
                                  return_aux=True)
    y, aux = M.moe_layer(p, cfg, torch.from_numpy(x), return_aux=True)
    _close(y.numpy(), y_ref, "float32")
    _close(np.asarray([float(aux)]), np.asarray([float(aux_ref)]), "float32")
    _close(M.moe_layer(p, cfg, torch.from_numpy(x)).numpy(),
           RM.moe_layer(p_ref, ref_cfg, jnp.asarray(x)), "float32")


def test_moe_layer_ep_without_a_mesh_is_the_sort_path():
    """The dispatch reads the bound mesh, as the reference's: no mesh, the
    sort path; a mesh with a ``model`` axis, the EP path for
    ``impl="ep_a2a"`` only (``test_torch_moe_ep`` holds that path)."""
    from repro_torch.launch.mesh import make_debug_mesh
    fields, (b, s) = MOE_CASES["smoke"]
    cfg = M.MoEConfig(**fields)
    ep = dataclasses.replace(cfg, impl="ep_a2a")
    p = M.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    sort = M.moe_layer(p, cfg, x)
    assert torch.equal(M.moe_layer(p, ep, x), sort)
    with sh.use_mesh(make_debug_mesh((1, 4), device="cpu")):
        assert M._ep_applicable(ep)
        assert torch.equal(M.moe_layer(p, cfg, x), sort)
        assert torch.equal(M.moe_layer(p, ep, x), M.moe_layer_ep(p, ep, x))


def test_moe_layer_is_deterministic_and_matches_a_per_token_loop():
    """No drop (capacity 4·T·k/E): y[t] = Σ_j gate_j · SwiGLU_e_j(x[t])."""
    fields, (b, s) = MOE_CASES["smoke"]
    cfg = M.MoEConfig(**fields)
    p = M.init_moe(torch.Generator().manual_seed(2), cfg)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    y = M.moe_layer(p, cfg, x)
    assert torch.equal(y, M.moe_layer(p, cfg, x))
    xt = x.reshape(b * s, -1)
    r = M.route(p["router"], cfg, xt, M._capacity(b * s, cfg))
    assert bool(r["keep"].all())
    want = torch.zeros_like(xt)
    for t in range(b * s):
        for j in range(cfg.top_k):
            ex = int(r["expert_idx"][t, j])
            h = torch.nn.functional.silu(xt[t] @ p["experts_gate"][ex])
            h = h * (xt[t] @ p["experts_up"][ex])
            want[t] += r["gate_vals"][t, j] * (h @ p["experts_down"][ex])
    torch.testing.assert_close(y.reshape(b * s, -1), want, rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# granite-moe-3b: config, converter, serving
# --------------------------------------------------------------------------

def test_granite_configs_match_reference():
    from repro.configs import get_config as ref_config
    for mine, ref in ((get_config("granite-moe-3b-a800m"),
                       ref_config("granite-moe-3b-a800m")),
                      (get_smoke_config("granite-moe-3b-a800m"),
                       ref_smoke_config("granite-moe-3b-a800m"))):
        for field in dataclasses.fields(mine):
            assert getattr(mine, field.name) == getattr(ref, field.name), \
                field.name
        assert mine.vocab_padded == ref.vocab_padded
        assert mine.ffn_kind == ref.ffn_kind == "moe"
    full = get_config("granite-moe-3b-a800m")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.vocab_size, full.n_experts,
            full.n_experts_padded, full.top_k, full.d_expert,
            full.moe_impl) == (32, 1536, 24, 8, 64, 49_155, 40, 48, 8, 512,
                               "ep_a2a")


@pytest.fixture(scope="module")
def granite():
    cfg_ref = ref_smoke_config("granite-moe-3b-a800m")
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    params = params_from_numpy(_flatten(params_ref), cfg, device="cpu")
    return cfg_ref, cfg, params_ref, params


def test_converter_carries_the_moe_leaves(granite):
    _, cfg, params_ref, params = granite
    moe_ref = params_ref["groups"]["b0"]["moe"]
    moe = params["groups"]["b0"]["moe"]
    assert sorted(moe) == sorted(moe_ref) == [
        "experts_down", "experts_gate", "experts_up", "router"]
    for k, v in moe_ref.items():
        np.testing.assert_array_equal(moe[k].numpy(), np.asarray(v))
    assert moe["experts_gate"].shape == (cfg.n_layers, cfg.n_experts_padded,
                                         cfg.d_model, cfg.d_expert)
    assert "mlp" not in params["groups"]["b0"]
    port = lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else
                        tuple(v.shape) for k, v in t.items()}
    assert shapes(port) == shapes(params)


def test_granite_smoke_prefill_and_decode_match_reference(granite):
    cfg_ref, cfg, params_ref, params = granite
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


def test_granite_smoke_greedy_tokens_match_reference(granite):
    cfg_ref, cfg, params_ref, params = granite
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 7))
    ref_tokens, _ = ref_engine.generate(
        params_ref, cfg_ref, {"tokens": jnp.asarray(prompts, jnp.int32)},
        ref_engine.SamplingConfig(max_new_tokens=8))
    before = moe_gemm.launches
    tokens, _ = generate(params, cfg, {"tokens": torch.from_numpy(prompts)},
                         SamplingConfig(max_new_tokens=8))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    assert tokens.shape == (3, 8)
    assert moe_gemm.launches == before       # CPU: the plain version only


def test_moe_training_is_not_ported_yet(granite):
    """MoE training was refused until the expert products got a backward;
    now ``forward`` and ``loss_fn`` run and equal the reference's
    (``test_torch_train_families`` holds the gradients)."""
    cfg_ref, cfg, params_ref, params = granite
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6))
    batch = {"tokens": torch.from_numpy(tok[:, :5]),
             "labels": torch.from_numpy(tok[:, 1:])}
    ref_batch = {k: jnp.asarray(v.numpy(), jnp.int32)
                 for k, v in batch.items()}
    per_layer = lm.unstack_layers(params)
    np.testing.assert_allclose(
        lm.forward(per_layer, cfg, batch).detach().numpy(),
        np.asarray(ref_lm.forward(params_ref, cfg_ref, ref_batch)), **TOL)
    got, _ = lm.loss_fn(per_layer, cfg, batch)
    want, _ = ref_lm.loss_fn(params_ref, cfg_ref, ref_batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_granite_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    tokens = main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device",
                   "cpu", "--batch", "2", "--prompt-len", "5", "--max-new",
                   "3"])
    assert tokens.shape == (2, 3) and "on cpu" in capsys.readouterr().out
