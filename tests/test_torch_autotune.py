"""Port parity: the plan autotuner (``repro_torch.kernels.autotune``) and
its knob space against ``repro.kernels.autotune``.

Surrogate-only: fingerprints, knob spaces, prescores, surrogate costs,
the search's report and the winning plan's arrays are exactly the
reference's on the golden patterns; the reference's three guarantees
(never worse than the default, deterministic, cached) hold in the port;
the calibration fit over ``BENCH_kernels.json`` equals the reference's.
The measured rung on the CPU returns one of its finalists.  The
autotuned serving head and sparse-MLP plan of the qwen3-4b smoke config
equal the reference's, their outputs within 1e-4.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.csr import BlockCSR as RefBlockCSR
from repro.core.sparsity import block_pattern_mask
from repro.kernels import autotune as ref_at
from repro.kernels import maple_spmm as ref_maple_spmm
from repro.kernels.schedule import pattern_fingerprint as ref_fingerprint
from repro.kernels.schedule import plan_spmm as ref_plan_spmm
from repro.kernels.schedule import spmm_knob_space as ref_knob_space
from repro.models import lm as ref_lm
from repro.models.layers import init_sparse_linear as ref_init_sparse_linear
from repro.serve import engine as ref_engine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import block_csr_from_numpy, params_from_numpy
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels import PartitionedSpmmPlan
from repro_torch.kernels import autotune as at
from repro_torch.kernels import maple_spmm, pattern_fingerprint, plan_spmm
from repro_torch.kernels import spmm_knob_space
from repro_torch.models import lm
from repro_torch.models.layers import sparse_linear
from repro_torch.serve import SparseLogitHead

ROOT = Path(__file__).resolve().parents[1]
GM = GK = 8
BM = BK = 8
KINDS = ("uniform", "power_law", "banded", "empty_rows")
PLAN_FIELDS = ("order", "step_row", "step_col", "written", "step_acc",
               "flush_slot", "slot_row", "row_mask", "r_max", "fused",
               "chunk")


def _both(kind, seed=0, extra_pad=0, payload_seed=1):
    rng = np.random.default_rng(seed)
    mask = block_pattern_mask("uniform" if kind == "empty_rows" else kind,
                              rng, GM, GK)
    if kind == "empty_rows":
        mask[1] = mask[5] = False
    d = np.random.default_rng(payload_seed).standard_normal(
        (GM * BM, GK * BK)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, BM, 0), BK, 1)
    cap = max(int(mask.sum()), 1) + extra_pad
    return (RefBlockCSR.from_dense(d, (BM, BK), n_blocks_max=cap),
            BlockCSR.from_dense(d, (BM, BK), n_blocks_max=cap, device="cpu"))


def _assert_plans_equal(got, want):
    for f in PLAN_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (np.array_equal(g, np.asarray(w)) if isinstance(g, np.ndarray)
                else g == w), f
    assert (getattr(got, "reorder", None) is None) == \
        (getattr(want, "reorder", None) is None)
    if getattr(got, "reorder", None) is not None:
        assert np.array_equal(got.reorder.perm, want.reorder.perm)


def _assert_train_plans_equal(got, want):
    _assert_plans_equal(got.fwd, want.fwd)
    _assert_plans_equal(got.bwd, want.bwd)
    assert np.array_equal(got.t_perm, np.asarray(want.t_perm))


@pytest.fixture(autouse=True)
def _fresh_caches():
    at.plan_cache_clear()
    ref_at.plan_cache_clear()
    yield
    at.plan_cache_clear()
    ref_at.plan_cache_clear()


@pytest.mark.parametrize("kind", KINDS)
def test_fingerprint_equals_reference_and_is_payload_blind(kind):
    ref_a, a = _both(kind)
    fp = pattern_fingerprint(a)
    assert fp == ref_fingerprint(ref_a)
    assert pattern_fingerprint(_both(kind, extra_pad=5)[1]) == fp
    assert pattern_fingerprint(_both(kind, payload_seed=9)[1]) == fp
    assert fp not in {pattern_fingerprint(_both(k)[1]) for k in KINDS
                      if k != kind}


@pytest.mark.parametrize("reorder", [False, True, "auto"])
@pytest.mark.parametrize("n_lanes_max", [4, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_knob_space_equals_reference(kind, n_lanes_max, reorder):
    ref_a, a = _both(kind)
    got = spmm_knob_space(a, n_lanes_max=n_lanes_max, reorder=reorder)
    want = ref_knob_space(ref_a, n_lanes_max=n_lanes_max, reorder=reorder)
    assert got == want and [list(c) for c in got] == [list(c) for c in want]


@pytest.mark.parametrize("kind", KINDS)
def test_prescore_and_surrogate_equal_reference(kind):
    ref_a, a = _both(kind)
    row_lens = np.diff(a.row_ptr.astype(np.int64))
    cal = {"us_per_cycle": 2.5, "us_base": -3.0}
    cfgs = spmm_knob_space(a)
    ranked = {}
    for name, mod, op in (("port", at, a), ("ref", ref_at, ref_a)):
        costs = []
        for cfg in cfgs:
            plan = mod.build_plan(op, cfg)
            costs.append(tuple(mod.surrogate_cost(plan, objective=obj,
                                                  calibration=cal)
                               for obj in ("cycles", "traffic", "us")))
        ranked[name] = costs
    assert ranked["port"] == ranked["ref"]
    assert [at._prescore(row_lens, c) for c in cfgs] == \
        [ref_at._prescore(row_lens, c) for c in cfgs]
    plan, ref_plan = plan_spmm(a, chunk=1), ref_plan_spmm(ref_a, chunk=1)
    for mode in ("rmw", "compact", "legacy_epilogue"):
        assert plan.output_traffic_bytes(2, 7, mode=mode) == \
            ref_plan.output_traffic_bytes(2, 7, mode=mode)
    assert at.plan_traffic_bytes(plan, g=2, n_cols=7) == \
        ref_at.plan_traffic_bytes(ref_plan, g=2, n_cols=7)
    with pytest.raises(ValueError, match="calibration"):
        at.surrogate_cost(plan, objective="us")
    with pytest.raises(ValueError, match="legacy_epilogue"):
        plan.output_traffic_bytes(1, 1, mode="epilogue")


@pytest.mark.parametrize("reorder", [False, "auto"])
@pytest.mark.parametrize("objective", ["cycles", "traffic"])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_search_equals_reference(kind, objective, reorder):
    ref_a, a = _both(kind)
    kw = dict(objective=objective, budget=16, reorder=reorder, full=True)
    plan, rep = at.plan_search(a, **kw)
    ref_plan, ref_rep = ref_at.plan_search(ref_a, **kw)
    for f in ("fingerprint", "objective", "budget", "n_candidates",
              "n_built", "best_config", "best_score", "default_score",
              "measured_us", "cache_hit"):
        assert getattr(rep, f) == getattr(ref_rep, f), f
    _assert_plans_equal(plan, ref_plan)


@pytest.mark.parametrize("kind", KINDS)
def test_never_worse_deterministic_and_cached(kind):
    _, a = _both(kind)
    default = plan_spmm(a).predicted_cycles()["plan"]
    p1, rep = at.plan_search(a, budget=8, full=True)
    assert p1.predicted_cycles()["plan"] <= default
    assert rep.best_score <= rep.default_score
    p2, rep2 = at.plan_search(a, budget=8, full=True)
    assert p2 is p1 and rep2.cache_hit and not rep.cache_hit
    assert at.plan_cache_stats() == {"hits": 1, "misses": 1, "size": 1}
    at.plan_cache_clear()
    assert at._plans_bit_identical(at.plan_search(a, budget=8), p1)
    # another capacity of the same pattern shares the cache line
    assert at.plan_search(_both(kind, extra_pad=4)[1], budget=8) is \
        at.plan_search(a, budget=8)


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "power_law"])
def test_plan_search_vjp_equals_reference(kind, reorder):
    ref_a, a = _both(kind)
    got = at.plan_search_vjp(a, budget=16, reorder=reorder)
    want = ref_at.plan_search_vjp(ref_a, budget=16, reorder=reorder)
    _assert_train_plans_equal(got, want)
    assert at.plan_search_vjp(a, budget=16, reorder=reorder) is got
    assert at._plans_bit_identical(got, got)
    # the reordered train plan runs: forward and both gradients
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (GK * BK, 5)).astype(np.float32)).requires_grad_()
    blocks = a.blocks.clone().requires_grad_()
    out = maple_spmm(dataclasses.replace(a, blocks=blocks), b, plan=got)
    ref_out = ref_maple_spmm(ref_a, jnp.asarray(b.detach().numpy()),
                             plan=want)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=1e-5, atol=1e-5)
    out.sum().backward()
    assert blocks.grad.shape == a.blocks.shape and b.grad is not None


def test_fit_calibration_equals_reference():
    path = ROOT / "BENCH_kernels.json"
    records = json.loads(path.read_text())["records"]
    got = at.fit_calibration(records, backend="cpu")
    assert got == ref_at.fit_calibration(records, backend="cpu")
    assert at.load_calibration(str(path)) == ref_at.load_calibration(
        str(path))
    assert at.fit_calibration(records[:1]) is None
    for pred in (0.0, 3.0, 1e4):
        assert at.calibrated_us(pred, got) == ref_at.calibrated_us(pred, got)


def test_measured_rung_on_cpu_returns_a_finalist():
    _, a = _both("power_law")
    plan, rep = at.plan_search(a, budget=16, measure=True, top_k=3, reps=1,
                               n_cols=8, full=True)
    assert len(rep.measured_us) == 3
    assert all(us > 0 for us in rep.measured_us.values())
    cfgs = spmm_knob_space(a)
    best = min(rep.measured_us, key=lambda i: (rep.measured_us[i], i))
    assert rep.best_config == cfgs[best]
    assert plan.fused == rep.best_config["fused"]
    assert at.plan_search(a, budget=16, measure=True, top_k=3, reps=1,
                          n_cols=8) is plan


def test_partitioned_search_is_not_ported():
    """The shard axis is ported: each call that used to refuse returns
    what the reference's does (the searched config, the knob space), a
    partitioned winner is a partitioned plan, and the argument checks
    below still raise."""
    ref_a, a = _both("uniform")
    for kw in (dict(shard_counts=(1, 2)), dict(col_shard_counts=(2,)),
               dict(shard_counts=(2,), col_shard_counts=(2,))):
        plan, rep = at.plan_search(a, budget=16, full=True, use_cache=False,
                                   **kw)
        _, want = ref_at.plan_search(ref_a, budget=16, full=True,
                                     use_cache=False, **kw)
        assert rep.best_config == want.best_config
        assert (rep.n_candidates, rep.best_score, rep.default_score) == (
            want.n_candidates, want.best_score, want.default_score)
        assert isinstance(plan, PartitionedSpmmPlan) == (
            rep.best_config["n_shards"] > 1)
    assert spmm_knob_space(a, shard_counts=(2,)) == ref_knob_space(
        ref_a, shard_counts=(2,))
    at.plan_cache_clear()
    assert at.auto_plan(a, n_shards=2) is at.auto_plan(a, n_shards=2)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (GK * BK, 4)).astype(np.float32))
    want = maple_spmm(a, b)
    torch.testing.assert_close(maple_spmm(a, b, plan="auto", n_shards=2),
                               want, rtol=1e-5, atol=1e-5)
    head = SparseLogitHead.build(a, plan="auto", n_col_shards=2)
    torch.testing.assert_close(head(b.t()[None]), want.t()[None],
                               rtol=1e-5, atol=1e-5)
    for kw, match in ((dict(budget=0), "budget"),
                      (dict(objective="x"), "objective"),
                      (dict(reorder="always"), "reorder")):
        with pytest.raises(ValueError, match=match):
            at.plan_search(a, **kw)


def test_autotune_smoke_cli(capsys):
    assert at.main(["--smoke", "--budget", "8"]) == 0
    out = capsys.readouterr().out
    assert out.count("autotune-smoke,") == 3 and "FAIL" not in out


def test_maple_spmm_auto_matches_reference():
    ref_a, a = _both("power_law", seed=4)
    b = np.random.default_rng(4).standard_normal((2, GK * BK, 9)).astype(
        np.float32)
    for reorder in (False, "auto", True):
        got = maple_spmm(a, torch.from_numpy(b), bn=16, plan="auto",
                         reorder=reorder)
        want = ref_maple_spmm(ref_a, jnp.asarray(b), bn=16, plan="auto",
                              reorder=reorder)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert at.plan_cache_stats()["misses"] == 3
    maple_spmm(a, torch.from_numpy(b), plan="auto")
    assert at.plan_cache_stats()["hits"] == 1


def _flatten_ref(tree):
    if isinstance(tree, RefBlockCSR):
        return {"blocks": np.asarray(tree.blocks),
                "block_col": np.asarray(tree.block_col),
                "block_row": np.asarray(tree.block_row),
                "row_ptr": np.asarray(tree.row_ptr),
                "shape": tree.shape, "block_shape": tree.block_shape}
    if isinstance(tree, dict):
        return {k: _flatten_ref(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def smoke():
    sparse = dict(sparse_mlp=True, sparse_block=(8, 8))
    cfg_ref = dataclasses.replace(ref_smoke_config("qwen3-4b"), **sparse)
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), **sparse)
    return cfg_ref, cfg, ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))


@pytest.mark.parametrize("trainable", [False, True])
def test_autotuned_head_equals_reference(smoke, trainable):
    _, cfg, _ = smoke
    w_ref = ref_init_sparse_linear(jax.random.PRNGKey(7), cfg.d_model,
                                   cfg.vocab_padded, block_shape=(8, 8),
                                   block_density=0.5)
    w = block_csr_from_numpy(_flatten_ref(w_ref), device="cpu")
    head_ref = ref_engine.SparseLogitHead.build(w_ref, plan="auto",
                                                trainable=trainable)
    head = SparseLogitHead.build(w, plan="auto", trainable=trainable)
    if trainable:
        _assert_train_plans_equal(head.plan, head_ref.plan)
    else:
        _assert_plans_equal(head.plan, head_ref.plan)
    assert SparseLogitHead.build(w, plan="auto",
                                 trainable=trainable).plan is head.plan
    hidden = np.random.default_rng(8).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    got = head(torch.from_numpy(hidden))
    want = head_ref(jnp.asarray(hidden))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        sparse_linear(w, torch.from_numpy(hidden), plan="auto").numpy(),
        np.asarray(want), rtol=1e-4, atol=1e-4)


def test_autotuned_sparse_mlp_plan_equals_reference(smoke):
    cfg_ref, cfg, params_ref = smoke
    plan_ref = ref_lm.sparse_mlp_plan(params_ref, autotune=True)
    params = params_from_numpy(_flatten_ref(params_ref), cfg, device="cpu")
    plan = lm.sparse_mlp_plan(params, autotune=True)
    _assert_train_plans_equal(plan, plan_ref)
    assert lm.sparse_mlp_plan(params, autotune=True) is plan
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 8))
    want = jax.jit(lambda p, t: ref_lm.forward(
        p, cfg_ref, {"tokens": t}, mlp_plan=plan_ref))(
            params_ref, jnp.asarray(tokens, jnp.int32))
    got = lm.forward(lm.unstack_layers(params), cfg,
                     {"tokens": torch.from_numpy(tokens)}, mlp_plan=plan)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
