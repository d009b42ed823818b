"""Port parity: the serving engine's host modules (``serve/queue.py``,
``serve/faults.py``, ``serve/paged_cache.py``) against ``repro``.

These are host numpy and plain Python, so everything is held exactly:
counters, allocator states, helper values, fault schedules field by
field, corrupted prompts.  Both packages take the same seeded operation
sequences.  ``_logical_kv`` runs on tensors and is held on both of its
branches (global and rolling caches).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import faults as ref_faults
from repro.serve import paged_cache as ref_pc
from repro.serve import queue as ref_queue
from repro_torch import serve as port_serve
from repro_torch.serve import faults, paged_cache, queue


def _req(mod, rng, rid, *, vocab=64, deadline=True):
    n = int(rng.integers(1, 12))
    return mod.Request(
        tokens=rng.integers(0, vocab, n).astype(np.int32),
        max_new_tokens=int(rng.integers(1, 10)),
        arrival=float(rng.integers(0, 8)),
        deadline=(float(rng.integers(2, 20)) if deadline
                  and rng.random() < 0.4 else None),
        eos_id=int(rng.integers(-1, 3)), rid=rid)


def test_status_names_and_exports_match_reference():
    assert queue.STATUSES == ref_queue.STATUSES
    for name in ("STATUS_OK", "STATUS_EOS", "STATUS_LENGTH",
                 "STATUS_DEADLINE", "STATUS_ERROR", "STATUS_REJECTED"):
        assert getattr(queue, name) == getattr(ref_queue, name)
        assert getattr(port_serve, name) == getattr(ref_queue, name)
    for name in ("ContinuousBatcher", "BatcherConfig", "RequestQueue",
                 "Request", "Completion", "FaultSchedule",
                 "PageAllocator", "STATUSES", "TransientStepError",
                 "apply_malformed", "corrupt_tokens", "jitted_prefill",
                 "jitted_decode_step"):
        assert name in port_serve.__all__ and hasattr(port_serve, name)
    assert ({f.name for f in dataclasses.fields(queue.Request)}
            == {f.name for f in dataclasses.fields(ref_queue.Request)})
    assert ({f.name for f in dataclasses.fields(queue.Completion)}
            == {f.name for f in dataclasses.fields(ref_queue.Completion)})


@pytest.mark.parametrize("kw", [dict(tokens=np.zeros(0, np.int32)),
                                dict(tokens=[1, 2], max_new_tokens=0)])
def test_request_validation_matches_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        ref_queue.Request(**kw, rid=0)
    with pytest.raises(ValueError) as err:
        queue.Request(**kw, rid=0)
    assert str(err.value) == str(ref_err.value)


def test_request_fields_and_properties_match_reference():
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    for rid in range(20):
        a, b = _req(ref_queue, rng_a, rid), _req(queue, rng_b, rid)
        assert b.tokens.dtype == a.tokens.dtype == np.int32
        np.testing.assert_array_equal(b.tokens, a.tokens)
        a.generated = b.generated = list(range(rid % 4))
        for now in (0.0, 3.0, 7.5, 19.0, 25.0):
            assert b.expired(now) == a.expired(now)
        assert (b.prompt_len, b.total_len, b.deadline_or_inf) == \
            (a.prompt_len, a.total_len, a.deadline_or_inf)
    # 2-D prompts flatten as in the reference
    assert queue.Request(tokens=[[1, 2], [3, 4]], rid=0).prompt_len == 4


@pytest.mark.parametrize("status", ["ok", "eos", "length",
                                    "deadline_exceeded", "error",
                                    "rejected"])
def test_completion_matches_reference(status):
    kw = dict(rid=3, prompt_len=5, tokens=[1, 2], finished_by=status,
              arrival=1.0, t_admit=2.5, t_first_token=2.5, t_done=9.0,
              steps=4)
    a, b = ref_queue.Completion(**kw), queue.Completion(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (b.ok, b.latency, b.queue_wait) == (a.ok, a.latency, a.queue_wait)
    with pytest.raises(ValueError, match="unknown status"):
        queue.Completion(**dict(kw, status="bogus"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_request_queue_counters_match_reference(seed):
    """A seeded sequence of submit / submit_all / requeue / shed /
    peek_ready / pop on both queues: the same answers, the same
    counters, the same order."""
    out = []
    for mod in (ref_queue, queue):
        rng = np.random.default_rng(seed)
        q = mod.RequestQueue(max_depth=int(rng.integers(3, 8)),
                             max_seq=int(rng.integers(8, 20)))
        log, rid = [], 0
        for step in range(60):
            op = int(rng.integers(0, 6))
            now = float(step // 3)
            if op == 0:
                log.append(q.submit(_req(mod, rng, rid)))
                rid += 1
            elif op == 1:
                reqs = [_req(mod, rng, rid + i) for i in range(3)]
                rid += 3
                log.append(q.submit_all(reqs))
            elif op == 2:
                r = _req(mod, rng, rid)
                rid += 1
                q.requeue(r)
            elif op == 3:
                log.append([r.rid for r in q.shed_expired(now)])
            elif op == 4:
                r = q.peek_ready(now)
                log.append(None if r is None else r.rid)
                if r is not None:
                    log.append(q.pop().rid)
            else:
                log.append((len(q), q.pending(), q.next_arrival()))
        log.append((q.accepted, q.rejected_depth, q.rejected_shape, q.shed,
                    q.requeued, len(q)))
        out.append(log)
    assert out[0] == out[1]


def _alloc_trace(mod, seed):
    rng = np.random.default_rng(seed)
    al = mod.PageAllocator(int(rng.integers(2, 12)), 4)
    held, log = [], []
    for _ in range(80):
        op = int(rng.integers(0, 6))
        try:
            if op in (0, 1):
                n = int(rng.integers(0, 4))
                log.append(("can", al.can_alloc(n)))
                pages = al.alloc(n)
                held.extend(pages)
                log.append(("alloc", pages))
            elif op == 2 and held:
                k = int(rng.integers(1, len(held) + 1))
                batch = [held.pop(int(rng.integers(0, len(held))))
                         for _ in range(k)]
                al.free(batch)
                log.append(("free", batch))
            elif op == 3:
                bad = int(rng.integers(0, 4))
                batch = ([mod.DEAD_PAGE], [al.n_pages + 1], [-1],
                         [held[0], held[0]] if held else [99])[bad]
                al.free(batch)
                log.append(("freed-bad", batch))
            elif op == 4 and held:
                pg = held[-1]
                al.free([pg])
                held.pop()
                al.free([pg])                  # double free
            else:
                log.append(("free_pages", al.free_pages()))
        except (RuntimeError, ValueError) as e:
            log.append((type(e).__name__, str(e)))
        log.append((al.in_use, al.peak_in_use, al.total_allocs,
                    list(al._free), sorted(al._allocated)))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_page_allocator_states_match_reference(seed):
    """A seeded sequence of allocs and frees, with every raise of the
    guarded free (the dead page, out of the pool on either side, double
    frees across calls and within one batch) and of an exhausted pool:
    the same pages, messages and states after every operation."""
    assert _alloc_trace(paged_cache, seed) == _alloc_trace(ref_pc, seed)
    assert paged_cache.DEAD_PAGE == ref_pc.DEAD_PAGE == 0
    with pytest.raises(ValueError, match="dead page"):
        paged_cache.PageAllocator(1, 4)


def test_paged_helpers_match_reference():
    for n in range(0, 40):
        for p in (1, 3, 4, 8, 16):
            assert paged_cache.pages_for(n, p) == ref_pc.pages_for(n, p)
            for horizon in (None, 0, 5, 8, 16):
                assert (paged_cache.reclaimable_pages(n, horizon, p)
                        == ref_pc.reclaimable_pages(n, horizon, p))
    rng = np.random.default_rng(5)
    for _ in range(10):
        slot_pages = [list(rng.integers(1, 50, int(rng.integers(0, 5))))
                      for _ in range(int(rng.integers(1, 6)))]
        got = paged_cache.make_table(slot_pages, 4)
        want = ref_pc.make_table(slot_pages, 4)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for mod in (paged_cache, ref_pc):
        with pytest.raises(ValueError, match="table width"):
            mod.make_table([[1, 2, 3, 4]], 3)
    al, ref_al = paged_cache.PageAllocator(9, 4), ref_pc.PageAllocator(9, 4)
    for a in (al, ref_al):
        a.free(a.alloc(5)[:2])
    assert (paged_cache.assert_paged_memory_bound(al, 6, 8)
            == ref_pc.assert_paged_memory_bound(ref_al, 6, 8))


SAMPLE_KW = (
    dict(p_transient=0.3, max_burst=3, p_poison=0.2, max_slot=4,
         p_deny=0.1, n_requests=10, p_malformed=0.2),
    dict(p_transient=0.1, max_burst=3, p_poison=0.08, max_slot=8,
         p_deny=0.08, n_requests=12, p_malformed=0.15),
    dict(p_poison=0.5, max_slot=0, p_deny=0.3),
    dict(),
)


@pytest.mark.parametrize("kw", SAMPLE_KW)
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fault_schedule_sample_matches_reference(seed, kw):
    got = faults.FaultSchedule.sample(seed, 64, **kw)
    want = ref_faults.FaultSchedule.sample(seed, 64, **kw)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.is_empty() == want.is_empty()
    for rnd in range(66):
        assert got.transient_failures(rnd) == want.transient_failures(rnd)
        assert got.poison_slot(rnd) == want.poison_slot(rnd)
        assert got.alloc_denied(rnd) == want.alloc_denied(rnd)
    assert got == faults.FaultSchedule.sample(seed, 64, **kw)
    assert faults.FaultSchedule().is_empty()
    assert issubclass(faults.TransientStepError, RuntimeError)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_corrupt_tokens_and_apply_malformed_match_reference(seed):
    toks = np.arange(9, dtype=np.int32)
    got = faults.corrupt_tokens(toks, 100, np.random.default_rng(seed))
    want = ref_faults.corrupt_tokens(toks, 100, np.random.default_rng(seed))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(toks, np.arange(9))     # copy, not view
    sched = faults.FaultSchedule.sample(seed, 8, n_requests=6,
                                        p_malformed=0.5)
    ref_sched = ref_faults.FaultSchedule.sample(seed, 8, n_requests=6,
                                                p_malformed=0.5)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, 50, int(rng.integers(1, 8))).astype(np.int32)
               for _ in range(5)]                # index 5 is past the list
    reqs = [queue.Request(tokens=p, rid=i) for i, p in enumerate(prompts)]
    ref_reqs = [ref_queue.Request(tokens=p, rid=i)
                for i, p in enumerate(prompts)]
    n = faults.apply_malformed(reqs, sched, 50, seed=seed)
    assert n == ref_faults.apply_malformed(ref_reqs, ref_sched, 50,
                                           seed=seed)
    for a, b in zip(reqs, ref_reqs):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("cache_len,padded", [(12, 12), (5, 12), (4, 8)])
def test_logical_kv_matches_reference_on_both_branches(cache_len, padded):
    """``cache_len == padded``: the global cache is already logical; a
    shorter (rolling local-window) cache is gathered modulo its length."""
    cache = np.random.default_rng(cache_len).standard_normal(
        (3, 1, cache_len, 2, 4)).astype(np.float32)
    got = paged_cache._logical_kv(torch.from_numpy(cache), padded)
    want = ref_pc._logical_kv(jnp.asarray(cache), padded)
    assert tuple(got.shape) == want.shape == (3, padded, 2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _serve_bench():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "benchmarks/serve_bench.py"
    spec = importlib.util.spec_from_file_location("serve_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,n_req,rate,prompt_hi,new_hi",
                         [(0, 10, 0.3, 16, 16), (7, 12, 0.5, 64, 16),
                          (3, 16, 0.5, 128, 32)])
def test_workload_matches_the_serve_bench(seed, n_req, rate, prompt_hi,
                                          new_hi):
    """``serve.workload`` draws the serving bench's Poisson requests and
    sizes its pool (global attention) exactly as the bench does."""
    from repro.configs import get_smoke_config as ref_smoke_config
    from repro_torch.serve.workload import poisson_requests, worst_pool
    bench = _serve_bench()
    cfg = ref_smoke_config("qwen3-4b")
    want = bench._poisson_workload(cfg, np.random.default_rng(seed),
                                   n_req=n_req, rate=rate,
                                   prompt_hi=prompt_hi, new_hi=new_hi)
    got = poisson_requests(cfg.vocab_size, seed, n_req=n_req, rate=rate,
                           prompt=(4, prompt_hi), new=(4, new_hi))
    assert [r.rid for r in got] == list(range(n_req))
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.tokens, w.tokens)
        assert g.tokens.dtype == w.tokens.dtype
        assert (g.max_new_tokens, g.arrival) == (w.max_new_tokens, w.arrival)
    for slots, page in ((4, 4), (8, 16), (2, 8)):
        assert worst_pool(got, slots, page) == bench._pool_for(
            cfg, want, max_slots=slots, page_size=page)
