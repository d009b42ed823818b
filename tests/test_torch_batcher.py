"""Port parity: the continuous batcher (``repro_torch.serve.batcher``)
against ``repro.serve.batcher`` on the CPU.

Both packages serve the same workloads (the reference serving bench's
scenario shapes: Poisson arrivals on the step clock, request ids set
explicitly) from the same weights (reference init, carried across with
``repro_torch.convert``).  Every ``Completion`` must be equal field by
field (greedy tokens, statuses, timestamps, steps, preemptions) and so
must every counter.  Sampled decoding cannot match ``jax.random``: the
port draws each request from its own generator, held on determinism and
on independence from the rest of the batch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import serve as ref_serve
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.models.layers import init_sparse_linear as ref_init_sparse_linear
from repro_torch import serve
from repro_torch.configs import get_smoke_config
from repro_torch.convert import block_csr_from_numpy, params_from_numpy
from repro_torch.serve import (BatcherConfig, ContinuousBatcher, Request,
                               RequestQueue, SamplingConfig, generate)
from repro_torch.serve.paged_cache import pages_for
from repro_torch.serve.workload import poisson_requests, worst_pool
from test_torch_serve import flatten_ref

# --------------------------------------------------------------------------
# models and workloads
# --------------------------------------------------------------------------


def load_models(arch):
    """(cfg_ref, cfg, params_ref, params): the reference's init at
    PRNGKey(0), carried across."""
    cfg_ref, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    return cfg_ref, cfg, params_ref, params_from_numpy(
        flatten_ref(params_ref), cfg, device="cpu")


def load_heads(cfg):
    """The serving bench's sparse head: (64, 64) blocks, density 0.5,
    drawn at PRNGKey(7); (reference head, port head)."""
    w = ref_init_sparse_linear(jax.random.PRNGKey(7), cfg.d_model,
                               cfg.vocab_padded, block_shape=(64, 64),
                               block_density=0.5)
    return (ref_serve.SparseLogitHead.build(w),
            serve.SparseLogitHead.build(block_csr_from_numpy(
                flatten_ref(w), device="cpu")))


@pytest.fixture(scope="module")
def qwen():
    return load_models("qwen3-4b")


@pytest.fixture(scope="module")
def qwen_heads(qwen):
    return load_heads(qwen[1])


def bench_setup(mod, vocab, seed, *, n_req, rate, chaos=False, max_slots=4,
                page_size=4):
    """The bench scenario's requests, ``BatcherConfig`` and faults (its
    chaos: the sampled schedule, malformed prompts, deadlines on every
    third request, the pool cut to 0.6 of the worst case)."""
    reqs = poisson_requests(vocab, seed, n_req=n_req, rate=rate,
                            prompt=(4, 16), new=(4, 16), request=mod.Request)
    max_seq = max(r.prompt_len + r.max_new_tokens for r in reqs)
    max_seq = pages_for(max_seq, page_size) * page_size
    n_pages = worst_pool(reqs, max_slots, page_size)
    faults = None
    if chaos:
        faults = mod.FaultSchedule.sample(
            seed, 64, p_transient=0.1, max_burst=3, p_poison=0.08,
            max_slot=max_slots, p_deny=0.08, n_requests=n_req,
            p_malformed=0.15)
        mod.apply_malformed(reqs, faults, vocab, seed=seed)
        for i, r in enumerate(reqs):
            if i % 3 == 1:
                r.deadline = r.arrival + 12.0
        biggest = max(pages_for(r.prompt_len + r.max_new_tokens, page_size)
                      for r in reqs)
        n_pages = max(biggest + 3, int(0.6 * n_pages))
    bcfg = mod.BatcherConfig(max_slots=max_slots, page_size=page_size,
                             n_pages=n_pages, max_seq=max_seq)
    return reqs, bcfg, faults


def engine_signature(eng):
    """Everything an engine run decides, for an equality check."""
    return {"completions": [dataclasses.asdict(c) for c in eng.completions],
            "counters": (eng.steps, eng.rounds, eng.admitted,
                         eng.occupancy_sum, eng.pages_reclaimed,
                         eng.allocator.peak_in_use,
                         eng.allocator.total_allocs, eng.allocator.in_use),
            "fault_stats": eng.fault_stats(),
            "memory_stats": eng.memory_stats(),
            "queue": (eng.queue.accepted, eng.queue.rejected_depth,
                      eng.queue.rejected_shape, eng.queue.shed,
                      eng.queue.requeued)}


def run_both(models, make, *, heads=None, **kw):
    """Serve ``make(mod)`` = (requests, BatcherConfig, faults) on both
    packages and hold every decision equal; returns the port's engine."""
    cfg_ref, cfg, params_ref, params = models
    engines = []
    for mod, c, p, h in ((ref_serve, cfg_ref, params_ref,
                          heads and heads[0]),
                         (serve, cfg, params, heads and heads[1])):
        reqs, bcfg, faults = make(mod)
        queue = mod.RequestQueue()
        assert queue.submit_all(reqs) == len(reqs)
        eng = mod.ContinuousBatcher(p, c, queue, bcfg, head=h,
                                    faults=faults, **kw)
        eng.run()
        engines.append(eng)
    assert engine_signature(engines[1]) == engine_signature(engines[0])
    return engines[1]


# --------------------------------------------------------------------------
# the bench's scenario shapes, on both packages
# --------------------------------------------------------------------------

SCENARIOS = {"plain": dict(seed=0, n_req=10, rate=0.3),
             "sparse_head": dict(seed=3, n_req=10, rate=0.3),
             "chaos": dict(seed=7, n_req=12, rate=0.5, chaos=True)}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_bench_scenario_matches_reference(qwen, qwen_heads, name):
    """The serving bench's ``serve_qwen3-4b`` (seed 0), its sparse-head
    shape (seed 3) and its chaos shape (seed 7: transient bursts past the
    retry budget, NaN poison, allocator denial, malformed prompts,
    deadlines, a pool at 0.6 of the worst case)."""
    kw = SCENARIOS[name]
    eng = run_both(qwen, lambda mod: bench_setup(mod, qwen[1].vocab_size,
                                                 **kw),
                   heads=qwen_heads if name == "sparse_head" else None)
    comps = eng.completions
    assert len(comps) == kw["n_req"] and eng.allocator.in_use == 0
    stats = eng.memory_stats()
    assert 0 < stats["peak_pages"] < stats["static_equiv_pages"]
    if name == "chaos":
        fs = eng.fault_stats()
        assert (fs["quarantined"] + fs["retries"] + fs["preemptions"]
                + fs["sheds"] + fs["errors"]) > 0
        assert all(c.status in serve.STATUSES for c in comps)
    else:
        assert all(c.status == "length" for c in comps)


@pytest.mark.timeout(120)
def test_granite_moe_scenario_matches_reference():
    """The bench's granite-moe shape (seed 6): the MoE layer serves in
    every fused step; capacity couples the rows, identically in both."""
    models = load_models("granite-moe-3b-a800m")
    eng = run_both(models, lambda mod: bench_setup(
        mod, models[1].vocab_size, seed=6, n_req=10, rate=0.3))
    assert len(eng.completions) == 10 and eng.allocator.in_use == 0


# --------------------------------------------------------------------------
# counterparts of the reference's engine tests
# --------------------------------------------------------------------------

def _prompts(cfg, seed, b, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, n))


def _generate(params, cfg, prompts, max_new):
    out, _ = generate(params, cfg, {"tokens": torch.from_numpy(
        np.asarray(prompts))}, SamplingConfig(max_new_tokens=max_new))
    return out.tolist()


@pytest.mark.timeout(120)
def test_continuous_batching_matches_generate(qwen):
    """A request admitted mid-stream decodes the greedy tokens of the
    same request alone through ``generate`` (matching cache geometry:
    prompt + max_new = max_pages · page_size)."""
    cfg_ref, cfg, params_ref, params = qwen
    prompt_len, max_new, page = 8, 8, 4
    prompts = _prompts(cfg, 3, 3, prompt_len)

    def make(mod):
        reqs = [mod.Request(tokens=prompts[i], max_new_tokens=max_new,
                            arrival=a, rid=i)
                for i, a in enumerate((0.0, 0.0, 3.0))]
        return reqs, mod.BatcherConfig(max_slots=4, page_size=page,
                                       n_pages=32,
                                       max_seq=prompt_len + max_new), None

    eng = run_both(qwen, make)
    comps = {c.rid: c for c in eng.completions}
    assert comps[2].t_admit == 3.0
    assert comps[2].tokens == _generate(params, cfg, prompts[2:3],
                                        max_new)[0]
    both = _generate(params, cfg, prompts[:2], max_new)
    assert [comps[0].tokens, comps[1].tokens] == both


@pytest.mark.timeout(120)
def test_paged_memory_scales_with_allocated_blocks(qwen):
    cfg_ref, cfg, params_ref, params = qwen
    rng = np.random.default_rng(11)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 12))),
              int(rng.integers(2, 10))) for _ in range(6)]
    worst = sum(pages_for(len(t) + m, 4) for t, m in specs)

    def make(mod):
        reqs = [mod.Request(tokens=t, max_new_tokens=m, rid=i)
                for i, (t, m) in enumerate(specs)]
        return reqs, mod.BatcherConfig(max_slots=6, page_size=4,
                                       n_pages=worst + 1, max_seq=32), None

    stats = run_both(qwen, make).memory_stats()
    assert stats["static_equiv_pages"] == 48
    assert stats["pool_pages"] == worst < 48
    assert 0 < stats["peak_pages"] <= worst


@pytest.mark.timeout(120)
def test_sparse_head_never_replans_across_admissions(qwen, qwen_heads,
                                                     monkeypatch):
    """Slot churn never replans: with the port's planners patched to
    raise, admissions at three live-slot counts go through the head's
    one plan, and the tokens equal a static run scoring against the
    densified head weight."""
    cfg_ref, cfg, params_ref, params = qwen
    head = qwen_heads[1]
    plan0 = head.plan
    queue = RequestQueue()
    eng = ContinuousBatcher(params, cfg, queue, BatcherConfig(
        max_slots=2, page_size=4, n_pages=32, max_seq=16), head=head)
    from repro_torch.kernels import autotune, partition, schedule
    from repro_torch.serve import engine as engine_mod

    def boom(*a, **k):
        raise AssertionError("slot churn triggered a replan")

    for mod, names in ((schedule, ("plan_spmm", "plan_spmm_vjp")),
                       (autotune, ("plan_search", "auto_plan")),
                       (partition, ("plan_partitioned_spmm",)),
                       (engine_mod, ("plan_spmm", "plan_spmm_vjp",
                                     "auto_plan",
                                     "plan_partitioned_spmm"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    prompts = [np.full(8, 3 + i, np.int32) for i in range(3)]
    for i, t in enumerate([0.0, 2.0, 6.0]):
        queue.submit(Request(tokens=prompts[i], max_new_tokens=4,
                             arrival=t, rid=i))
    comps = {c.rid: c for c in eng.run()}
    monkeypatch.undo()
    assert len(comps) == 3 and eng.head.plan is plan0
    oracle = dict(params, lm_head=head.weight.to_dense())
    for i in range(3):
        assert comps[i].tokens == _generate(oracle, cfg, prompts[i][None],
                                            4)[0]


@pytest.mark.timeout(120)
def test_engine_ragged_eos_retires_slots(qwen):
    """A request retiring on EOS frees its one slot for the next."""
    cfg_ref, cfg, params_ref, params = qwen
    prompt = _prompts(cfg, 5, 1, 8)
    eos = _generate(params, cfg, prompt, 8)[0][0]

    def make(mod):
        return ([mod.Request(tokens=prompt[0], max_new_tokens=8, eos_id=eos,
                             rid=0),
                 mod.Request(tokens=prompt[0], max_new_tokens=3, rid=1)],
                mod.BatcherConfig(max_slots=1, page_size=4, n_pages=16,
                                  max_seq=16), None)

    comps = run_both(qwen, make).completions
    assert [c.finished_by for c in comps] == ["eos", "length"]
    assert comps[0].tokens == [eos] and len(comps[1].tokens) == 3


@pytest.mark.timeout(120)
def test_collected_entropy_matches_reference(qwen):
    """``collect_entropy=True``: after the same rounds, each live slot's
    trace (one entropy a draw, over the real vocabulary) is within 1e-4
    of the reference's, its tokens equal."""
    cfg_ref, cfg, params_ref, params = qwen
    engines = []
    for mod, c, p in ((ref_serve, cfg_ref, params_ref),
                      (serve, cfg, params)):
        queue = mod.RequestQueue()
        queue.submit_all([mod.Request(tokens=_prompts(cfg, 7 + i, 1, 6)[0],
                                      max_new_tokens=8, rid=i)
                          for i in range(2)])
        eng = mod.ContinuousBatcher(p, c, queue, mod.BatcherConfig(
            max_slots=2, page_size=4, n_pages=16, max_seq=16,
            collect_entropy=True))
        for t in range(4):
            eng.step(float(t))
        engines.append(eng)
    for want, got in zip(*(e.slots for e in engines)):
        assert len(got.entropy) == 5 and got.out == want.out
        np.testing.assert_allclose(got.entropy, want.entropy, rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------------------------------
# the port's own randomness: a generator per request
# --------------------------------------------------------------------------

SAMPLED = SamplingConfig(temperature=0.8, top_k=20)


def _serve(params, cfg, reqs, bcfg, *, seed=0, head=None, faults=None,
           sampling=SAMPLED):
    queue = RequestQueue()
    queue.submit_all(reqs)
    eng = ContinuousBatcher(params, cfg, queue, bcfg, sampling=sampling,
                            head=head, seed=seed, faults=faults)
    return eng, {c.rid: c for c in eng.run()}


def _workload(cfg, seed=0, n_req=6):
    return poisson_requests(cfg.vocab_size, seed, n_req=n_req, rate=0.5,
                            prompt=(4, 16), new=(4, 16))


BCFG = BatcherConfig(max_slots=4, page_size=4, n_pages=48, max_seq=32)


@pytest.mark.timeout(60)
def test_sampled_runs_are_deterministic_per_seed(qwen, qwen_heads):
    _, cfg, _, params = qwen
    runs = [_serve(params, cfg, _workload(cfg), BCFG, head=qwen_heads[1])[1]
            for _ in range(2)]
    assert runs[0] == runs[1]
    other = _serve(params, cfg, _workload(cfg), BCFG, seed=1,
                   head=qwen_heads[1])[1]
    assert [c.tokens for c in other.values()] != \
        [c.tokens for c in runs[0].values()]


@pytest.mark.timeout(60)
def test_sampled_tokens_do_not_depend_on_the_batch(qwen):
    """A request's draws come from its own generator, seeded from (seed,
    rid): alone in the engine it samples the tokens it samples among
    others."""
    _, cfg, _, params = qwen
    batch = _serve(params, cfg, _workload(cfg), BCFG)[1]
    for req in _workload(cfg)[:3]:
        req.arrival = 0.0
        alone = _serve(params, cfg, [req], BCFG)[1]
        assert alone[req.rid].tokens == batch[req.rid].tokens


@pytest.mark.timeout(60)
def test_preempted_sampled_request_draws_the_uninterrupted_tokens(qwen):
    """Preemption hands the generator to the requeued request and the
    re-prefill continues its chain; a fallback drain hands it to
    ``complete_static``.  Either way the request samples what it samples
    uninterrupted."""
    _, cfg, _, params = qwen
    pa, pb = _prompts(cfg, 3, 1, 8)[0], _prompts(cfg, 4, 1, 8)[0]

    def reqs():
        return [Request(tokens=pa, max_new_tokens=12, rid=0),
                Request(tokens=pb, max_new_tokens=4, arrival=2.0, rid=1)]

    free = _serve(params, cfg, reqs(), BCFG)[1]
    eng, tight = _serve(params, cfg, reqs(), BatcherConfig(
        max_slots=2, page_size=4, n_pages=6, max_seq=32))
    assert eng.preemptions >= 1 and tight[0].preemptions >= 1
    assert {r: (c.tokens, c.status) for r, c in tight.items()} == \
        {r: (c.tokens, c.status) for r, c in free.items()}
    eng, drained = _serve(params, cfg, reqs(), BCFG,
                          faults=serve.FaultSchedule(transient={2: 3}))
    assert eng.fallbacks == 1
    assert {r: c.tokens for r, c in drained.items()} == \
        {r: c.tokens for r, c in free.items()}
