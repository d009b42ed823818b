"""Port parity of the reference's two model examples on the CPU:
``repro_torch.examples.serve_lm`` against ``examples/serve_lm.py`` and
``repro_torch.examples.train_lm`` against ``examples/train_lm.py``.

* serve_lm on the reference's weights and prompts (its ``PRNGKey(0)``
  split four ways, carried across): the prefill's logits within 1e-4 and
  ``pos`` equal; the T=0 tokens equal; the T=0.8 tokens the same on a
  second run of one seed; the engine's completions (rid, status,
  ``finished_by``, tokens, queue wait, latency, preemptions), its fused
  steps and ``memory_stats()``, and the failure part's completions and
  ``fault_stats()``, all equal to the reference engine's on the same
  requests.
* ``lm_125m`` equals the reference's config field by field, with the same
  ``param_count()``.
* ``--sparse-mlp`` at the example's widths with 2 of its 10 layers (seq 16,
  batch 2, 2 microbatches, 2 steps) from the reference's weights: losses
  and grad norms within 1e-4 relative of the reference's
  ``jax.jit(make_train_step(...))``, the plan's ``predicted_cycles()``
  exactly equal; ``--partition 2`` on the CPU within 1e-5 relative of
  ``--partition 1``; a checkpoint saved between steps loads back bit for
  bit.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import DataConfig as RefDataConfig
from repro.data import synth_batch as ref_synth_batch
from repro.models import lm as ref_lm
from repro import serve as ref_serve
from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.examples import serve_lm, train_lm
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models import lm
from repro_torch.train.optimizer import named_leaves
from test_torch_train import flatten_ref

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SMALL = dict(steps=2, seq_len=16, global_batch=2, micro_batches=2, lr=3e-4)


def reference_example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --------------------------------------------------------------------------
# serve_lm
# --------------------------------------------------------------------------

def reference_serve_lm():
    """The reference example's three parts (``examples/serve_lm.py``) on
    its own weights and prompts, the requests numbered 0 to 10 as a
    fresh process numbers them."""
    cfg = ref_smoke_config(serve_lm.ARCH)
    key_params, key_prompts, key_sample, key_engine = jax.random.split(
        jax.random.PRNGKey(0), 4)
    params = ref_lm.init_params(cfg, key_params)
    prompts = jax.random.randint(key_prompts, (4, 24), 0, cfg.vocab_size)
    logits, state = jax.jit(
        lambda p, b: ref_lm.prefill(p, cfg, b, max_seq=24 + 64)
    )(params, {"tokens": prompts})
    toks, _ = ref_serve.generate(
        params, cfg, {"tokens": prompts},
        ref_serve.SamplingConfig(temperature=0.0, top_k=40,
                                 max_new_tokens=16), key=key_sample)
    rng = np.random.default_rng(0)
    queue = ref_serve.RequestQueue()
    now = 0.0
    for i in range(8):
        now += float(rng.exponential(2.0))
        n = int(rng.integers(8, 25))
        queue.submit(ref_serve.Request(
            tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 17)), arrival=now, rid=i))
    engine = ref_serve.ContinuousBatcher(
        params, cfg, queue,
        ref_serve.BatcherConfig(max_slots=4, page_size=8, n_pages=24,
                                max_seq=48), key=key_engine)
    engine.run()
    queue = ref_serve.RequestQueue()
    good = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    bad = good.copy()
    bad[3] = cfg.vocab_size + 17
    queue.submit(ref_serve.Request(tokens=good, max_new_tokens=8,
                                   arrival=0.0, rid=8))
    queue.submit(ref_serve.Request(tokens=bad, max_new_tokens=8,
                                   arrival=0.0, rid=9))
    queue.submit(ref_serve.Request(tokens=good.copy(), max_new_tokens=8,
                                   arrival=0.0, deadline=1.0, rid=10))
    failure = ref_serve.ContinuousBatcher(
        params, cfg, queue,
        ref_serve.BatcherConfig(max_slots=2, page_size=8, n_pages=24,
                                max_seq=48), key=key_engine,
        faults=ref_serve.FaultSchedule(transient={2: 2}))
    failure.run()
    return {"params": params, "prompts": np.asarray(prompts),
            "logits": np.asarray(logits), "pos": int(state["pos"]),
            "t0": np.asarray(toks), "engine": engine, "failure": failure}


@pytest.fixture(scope="module")
def served():
    ref = reference_serve_lm()
    got = serve_lm.run("cpu", params=params_from_numpy(
        flatten_ref(ref["params"]), get_smoke_config(serve_lm.ARCH),
        device="cpu"), prompts=ref["prompts"])
    return ref, got


def completions(engine):
    return [(c.rid, c.status, c.finished_by, list(c.tokens), c.queue_wait,
             c.latency, c.preemptions) for c in engine.completions]


def test_serve_lm_prefill_follows_the_reference(served):
    ref, got = served
    np.testing.assert_allclose(got["static"]["logits"].numpy(),
                               ref["logits"], rtol=1e-4, atol=1e-4)
    assert got["static"]["pos"] == ref["pos"] == 24


def test_serve_lm_greedy_tokens_equal_the_reference(served):
    ref, got = served
    assert np.array_equal(got["static"]["tokens"][0.0].numpy(), ref["t0"])
    assert got["lines"][1].startswith("T=0.0: 16 tokens × 4 rows")


def test_serve_lm_sampled_tokens_repeat_for_one_seed(served):
    _, got = served
    again = serve_lm.static_path(got["params"], got["cfg"], got["prompts"],
                                 got["sample_seed"], [])
    first = got["static"]["tokens"]
    assert torch.equal(again["tokens"][0.8], first[0.8])
    assert torch.equal(again["tokens"][0.0], first[0.0])
    assert tuple(first[0.8].shape) == (4, 16)


def test_serve_lm_engine_equals_the_reference(served):
    ref, got = served
    eng, want = got["engine"], ref["engine"]
    assert completions(eng) == completions(want)
    assert len(eng.completions) == 8
    assert eng.steps == want.steps
    assert eng.memory_stats() == want.memory_stats()
    assert sum(len(c.tokens) for c in eng.completions) == 90


def test_serve_lm_failure_part_equals_the_reference(served):
    ref, got = served
    eng, want = got["failure"], ref["failure"]
    assert completions(eng) == completions(want)
    assert eng.fault_stats() == want.fault_stats()
    assert {c.rid: c.status for c in eng.completions} == {
        8: "length", 9: "rejected", 10: "deadline_exceeded"}
    assert got["lines"][-1] == f"  counters: {want.fault_stats()}"


# --------------------------------------------------------------------------
# train_lm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sparse_mlp", [False, True])
def test_lm_125m_equals_the_reference(sparse_mlp):
    want = reference_example("train_lm").lm_125m(sparse_mlp)
    got = train_lm.lm_125m(sparse_mlp)
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name
    assert got.param_count() == want.param_count() == 123_371_520


def small_config(module):
    """The example's sparse-MLP config with 2 of its 10 layers."""
    return dataclasses.replace(module.lm_125m(True), n_layers=2)


@pytest.fixture(scope="module")
def trained():
    """The reference example's loop (``jax.jit(make_train_step(...))``,
    the plan over its one CPU device) and the port's ``run`` from the
    same weights."""
    cfg = small_config(reference_example("train_lm"))
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    start = params_from_numpy(flatten_ref(params), small_config(train_lm),
                              device="cpu")
    got = train_lm.run(small_config(train_lm), device="cpu",
                       params=start, **SMALL)
    plan = ref_lm.sparse_mlp_plan(params, n_shards=len(jax.local_devices()))
    ocfg = RefOptimizerConfig(peak_lr=SMALL["lr"], warmup_steps=5,
                              total_steps=100)
    opt = ref_init_opt_state(ocfg, params)
    dcfg = RefDataConfig(vocab_size=cfg.vocab_size, seq_len=SMALL["seq_len"],
                         global_batch=SMALL["global_batch"])
    step = jax.jit(ref_make_train_step(cfg, ocfg, SMALL["micro_batches"],
                                       mlp_plan=plan))
    want = []
    for s in range(SMALL["steps"]):
        params, opt, m = step(params, opt, ref_synth_batch(dcfg, s))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    return got, want, plan, start


def test_sparse_training_follows_the_reference_jitted_steps(trained):
    got, want, _, _ = trained
    np.testing.assert_allclose([r["loss"] for r in got.history],
                               [w[0] for w in want], rtol=1e-4)
    np.testing.assert_allclose([r["grad_norm"] for r in got.history],
                               [w[1] for w in want], rtol=1e-4)
    assert got.step_fn.__name__ == "train_step"          # eager on the CPU
    assert got.lines[-1] == "done" and len(got.lines) == 2 + 2 + 1


def test_sparse_mlp_plan_predicts_the_reference_cycles(trained):
    got, _, plan, _ = trained
    assert got.n_shards == 1
    assert got.mlp_plan.predicted_cycles() == plan.predicted_cycles()
    pc = plan.predicted_cycles()
    assert got.lines[1] == (f"sparse mlp plan: fwd {pc['fwd_plan']:.0f} + "
                            f"A^T {pc['at_plan']:.0f} block-MACs/lane "
                            f"predicted")


def test_two_shards_on_the_cpu_follow_one(trained):
    """``--partition 2``: both sides of the plan partitioned, the shards
    one after another on the CPU (B1 + the row-offset merge, B2 per
    shard, as plain versions)."""
    got, _, _, start = trained
    two = train_lm.run(small_config(train_lm), device="cpu", params=start,
                       partition=2, **SMALL)
    assert two.n_shards == 2 and two.mlp_plan.fwd.n_shards == 2
    assert two.lines[1].endswith("predicted over 2 devices")
    np.testing.assert_allclose([r["loss"] for r in two.history],
                               [r["loss"] for r in got.history], rtol=1e-5)


def test_a_checkpoint_between_steps_loads_back_bit_equal(trained, tmp_path,
                                                         monkeypatch):
    _, _, _, start = trained
    monkeypatch.setattr(train_lm, "CKPT_EVERY", 2)
    got = train_lm.run(small_config(train_lm), device="cpu", params=start,
                       ckpt_dir=str(tmp_path), **SMALL)
    assert ckpt.latest_step(str(tmp_path)) == 2
    step, back = ckpt.load(str(tmp_path), {"params": got.params,
                                           "opt": got.opt})
    assert step == 2
    for (k, a), (kb, b) in zip(named_leaves(back["params"]),
                               named_leaves(got.params)):
        assert k == kb and torch.equal(a, b), k
    for name in ("m", "v"):
        for k, t in getattr(got.opt, name).items():
            assert torch.equal(getattr(back["opt"], name)[k], t), (name, k)
    assert torch.equal(back["opt"].step, got.opt.step)
    assert lm.sparse_mlp_plan(back["params"]) is not None
