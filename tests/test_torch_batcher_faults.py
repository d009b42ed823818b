"""Port parity: the continuous batcher's failure semantics against
``repro`` on the CPU (counterparts of ``tests/test_serve_faults.py``):
deadlines and sheds, preemption and resume, ``preempt=False``,
quarantine, NaN poison, bounded retry and the fallback drain, and a
seeded fault schedule.  Each case runs on both packages with request ids
set explicitly (``test_torch_batcher.run_both``: every completion and
counter equal), then is held to the reference test's own claims against
the port's ``generate``.
"""

import numpy as np
import pytest

from repro_torch.serve import STATUS_DEADLINE, STATUS_REJECTED
from test_torch_batcher import _generate, load_models, run_both


@pytest.fixture(scope="module")
def smoke():
    return load_models("qwen3-4b")


def _prompt(cfg, n=8, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n) \
        .astype(np.int32)


def _ref_tokens(smoke, prompt, max_new):
    _, cfg, _, params = smoke
    return _generate(params, cfg, prompt[None], max_new)[0]


def _bcfg(mod, **kw):
    return mod.BatcherConfig(**dict(dict(page_size=4, n_pages=32,
                                         max_seq=32), **kw))


@pytest.mark.timeout(120)
def test_deadline_sheds_queued_and_retires_inflight(smoke):
    cfg = smoke[1]
    prompt = _prompt(cfg)

    def make(mod):
        reqs = [mod.Request(tokens=prompt, max_new_tokens=10, rid=0),
                mod.Request(tokens=prompt, max_new_tokens=4, deadline=3.0,
                            rid=1),
                mod.Request(tokens=prompt, max_new_tokens=3, rid=2)]
        return reqs, _bcfg(mod, max_slots=1), None

    eng = run_both(smoke, make)
    comps = {c.rid: c for c in eng.completions}
    assert comps[1].status == STATUS_DEADLINE and comps[1].tokens == []
    assert not comps[1].ok
    assert (comps[0].status, len(comps[0].tokens)) == ("length", 10)
    assert (comps[2].status, len(comps[2].tokens)) == ("length", 3)
    assert eng.sheds == 1 and eng.expired == 0

    def make_inflight(mod):
        return ([mod.Request(tokens=prompt, max_new_tokens=20, deadline=5.0,
                             rid=3)], _bcfg(mod, max_slots=1), None)

    eng = run_both(smoke, make_inflight)
    comp = eng.completions[0]
    assert comp.status == STATUS_DEADLINE and 0 < len(comp.tokens) < 20
    assert comp.tokens == _ref_tokens(smoke, prompt, 20)[:len(comp.tokens)]
    assert eng.expired == 1 and eng.allocator.in_use == 0


def _two(cfg, max_new=(12, 4), arrival=2.0, seeds=(3, 4)):
    pa, pb = _prompt(cfg, seed=seeds[0]), _prompt(cfg, seed=seeds[1])

    def reqs(mod):
        return [mod.Request(tokens=pa, max_new_tokens=max_new[0], rid=0),
                mod.Request(tokens=pb, max_new_tokens=max_new[1],
                            arrival=arrival, rid=1)]
    return pa, pb, reqs


@pytest.mark.timeout(120)
def test_preemption_resume_is_bit_identical(smoke):
    """Five usable pages, which A alone fills by its end: B's arrival
    forces at least one eviction, and the victim resumes by re-prefill
    with the uninterrupted greedy tokens."""
    pa, pb, reqs = _two(smoke[1])
    eng = run_both(smoke, lambda mod: (reqs(mod), _bcfg(
        mod, max_slots=2, n_pages=6), None))
    comps = {c.rid: c for c in eng.completions}
    assert comps[0].tokens == _ref_tokens(smoke, pa, 12)
    assert comps[1].tokens == _ref_tokens(smoke, pb, 4)
    assert comps[0].status == "length" and eng.preemptions >= 1
    assert comps[0].preemptions + comps[1].preemptions == eng.preemptions
    assert comps[0].t_admit == 0.0 and eng.allocator.in_use == 0


@pytest.mark.timeout(120)
def test_preempt_disabled_blocks_instead(smoke):
    pa, pb, reqs = _two(smoke[1])
    eng = run_both(smoke, lambda mod: (reqs(mod), _bcfg(
        mod, max_slots=2, n_pages=6, preempt=False), None))
    comps = {c.rid: c for c in eng.completions}
    assert eng.preemptions == 0
    assert comps[0].tokens == _ref_tokens(smoke, pa, 12)
    assert comps[1].tokens == _ref_tokens(smoke, pb, 4)
    assert comps[1].t_admit > comps[0].t_done - 1e-9


@pytest.mark.timeout(120)
def test_malformed_request_quarantined(smoke):
    cfg = smoke[1]
    good = _prompt(cfg)
    bad = good.copy()
    bad[3] = cfg.vocab_size + 17

    def make(mod):
        return ([mod.Request(tokens=bad, max_new_tokens=5, rid=0),
                 mod.Request(tokens=good, max_new_tokens=5, rid=1),
                 mod.Request(tokens=np.array([1, -2, 3], np.int32),
                             max_new_tokens=2, arrival=9.0, rid=2)],
                _bcfg(mod, max_slots=2), None)

    eng = run_both(smoke, make)
    comps = {c.rid: c for c in eng.completions}
    assert comps[0].status == comps[2].status == STATUS_REJECTED
    assert comps[0].tokens == [] and not comps[0].ok
    assert comps[1].tokens == _ref_tokens(smoke, good, 5)
    assert eng.quarantined == 2


@pytest.mark.timeout(120)
def test_nan_poison_isolated_to_one_slot(smoke):
    """Slot 0's logits go NaN after round 2 (in a copy): it retires with
    ``status="error"`` after three tokens, slot 1 is untouched."""
    pa, pb, reqs = _two(smoke[1], max_new=(8, 8), arrival=0.0,
                        seeds=(5, 6))
    eng = run_both(smoke, lambda mod: (reqs(mod), _bcfg(mod, max_slots=2),
                                       mod.FaultSchedule(poison={2: 0})))
    comps = {c.rid: c for c in eng.completions}
    assert comps[0].status == "error"
    assert comps[0].tokens == _ref_tokens(smoke, pa, 8)[:3]
    assert comps[1].status == "length"
    assert comps[1].tokens == _ref_tokens(smoke, pb, 8)
    assert eng.errors == 1 and eng.allocator.in_use == 0
    pool = eng.state["groups"]["b0"]
    assert all(bool(pool[n].isfinite().all()) for n in ("k", "v"))


@pytest.mark.timeout(120)
def test_transient_failures_absorbed_by_retry(smoke):
    prompt = _prompt(smoke[1])
    eng = run_both(smoke, lambda mod: (
        [mod.Request(tokens=prompt, max_new_tokens=8, rid=0)],
        _bcfg(mod, max_slots=1, max_retries=2),
        mod.FaultSchedule(transient={1: 2, 4: 1})))
    assert eng.completions[0].tokens == _ref_tokens(smoke, prompt, 8)
    assert eng.retries == 3 and eng.fallbacks == 0


@pytest.mark.timeout(120)
def test_retry_exhaustion_degrades_to_static_path(smoke):
    pa, pb, reqs = _two(smoke[1], max_new=(8, 6), arrival=0.0,
                        seeds=(5, 6))
    eng = run_both(smoke, lambda mod: (
        reqs(mod), _bcfg(mod, max_slots=2, max_retries=2),
        mod.FaultSchedule(transient={2: 3})))
    comps = {c.rid: c for c in eng.completions}
    assert eng.fallbacks == 1 and eng.retries == 2
    assert comps[0].tokens == _ref_tokens(smoke, pa, 8)
    assert comps[1].tokens == _ref_tokens(smoke, pb, 6)
    assert {c.status for c in comps.values()} == {"length"}
    assert eng.allocator.in_use == 0


@pytest.mark.timeout(120)
def test_engine_matches_reference_under_fault_schedule(smoke):
    """The reference test's seeded chaos (schedule seed 11: transient
    bursts, poison, denial, malformed prompts, random deadlines,
    ``max_retries=1``) on both packages: equal completions and counters,
    every request accounted for, the chaos biting."""
    cfg = smoke[1]

    def make(mod):
        rng = np.random.default_rng(11)
        sched = mod.FaultSchedule.sample(
            11, 40, p_transient=0.15, max_burst=2, p_poison=0.1, max_slot=3,
            p_deny=0.1, n_requests=8, p_malformed=0.2)
        reqs = []
        for i in range(8):
            n = int(rng.integers(2, 10))
            reqs.append(mod.Request(
                tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 8)),
                arrival=float(rng.integers(0, 6)),
                deadline=(float(rng.integers(8, 30))
                          if rng.random() < 0.5 else None), rid=i))
        mod.apply_malformed(reqs, sched, cfg.vocab_size, seed=11)
        return reqs, _bcfg(mod, max_slots=3, n_pages=48, max_retries=1), \
            sched

    eng = run_both(smoke, make)
    assert len(eng.completions) == 8
    assert "rejected" in {c.status for c in eng.completions}
    assert eng.retries > 0
