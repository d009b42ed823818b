"""Serving examples: the reference batched loop and the continuous engine
(port of ``examples/serve_lm.py``).

Part 1 exercises the static path (prefill a fixed batch, lock-step
sampled decode) on a reduced hybrid model (recurrentgemma family:
RG-LRU + rolling local-attention cache; on the card each local-attention
layer of a prefill is one block-sparse attention launch, B9).  Part 2
drives the same model through the continuous-batching engine: Poisson
arrivals into the request queue, paged KV cache, per-request retirement;
on the card its fused step is one captured CUDA graph.  Part 3 turns on
the failure-semantics layer: a deadline that retires a request
mid-decode with partial output, a malformed request quarantined at
admission, and a seeded FaultSchedule injecting transient step failures
absorbed by retry-with-replay — every completion still comes back with
an honest status.

Sampled decoding draws from a ``torch.Generator`` on the device, which
cannot reproduce the reference's ``jax.random`` draws: greedy tokens
(T=0) and every engine decision (greedy as well) are the reference's,
the T=0.8 row is this port's own for its seed.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.examples import say
from repro_torch.serve import (BatcherConfig, ContinuousBatcher,
                               FaultSchedule, Request, RequestQueue,
                               SamplingConfig, generate, jitted_prefill)
from repro_torch.train.optimizer import tree_map

ARCH = "recurrentgemma-9b"
BATCH, PROMPT_LEN = 4, 24


def _wait(device: torch.device) -> None:
    """Wait for the card's work, so that a host clock read after it holds
    it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def static_path(params, cfg, prompts, sample_seed, lines) -> dict:
    """Part 1: the batch prefilled once (the jitted prefill's callable),
    then ``generate`` at T=0 and at T=0.8 with top-k 40, each from a
    generator seeded ``sample_seed``.  Returns the prefill's logits and
    ``pos``, and the tokens by temperature."""
    dev = prompts.device
    t0 = time.perf_counter()
    logits, state = jitted_prefill(cfg, max_seq=PROMPT_LEN + 64)(
        params, batch={"tokens": prompts})
    _wait(dev)
    t_prefill = time.perf_counter() - t0
    pos = int(state["pos"])
    say(lines, f"prefill: batch={BATCH} len={PROMPT_LEN} "
               f"pos={pos} ({t_prefill:.2f}s incl. compile)")
    tokens = {}
    for temp in (0.0, 0.8):
        t0 = time.perf_counter()
        toks, _ = generate(
            params, cfg, {"tokens": prompts},
            SamplingConfig(temperature=temp, top_k=40, max_new_tokens=16),
            generator=torch.Generator(device=dev).manual_seed(sample_seed))
        _wait(dev)
        dt = time.perf_counter() - t0
        tokens[temp] = toks.cpu()
        say(lines, f"T={temp}: {toks.shape[1]} tokens × {BATCH} rows in "
                   f"{dt:.2f}s | first row: {toks[0].tolist()}")
    return {"logits": logits, "pos": pos, "tokens": tokens}


def engine_path(params, cfg, rng, engine_seed, lines) -> ContinuousBatcher:
    """Part 2: 8 requests with staggered arrivals (in step-clock units),
    their prompts and lengths drawn from ``rng``, through the engine:
    requests join mid-decode by claiming free slots; pages are allocated
    per request and — for this local-window config — reclaimed behind the
    horizon.  Returns the drained engine."""
    queue = RequestQueue()
    now = 0.0
    for i in range(8):
        now += float(rng.exponential(2.0))
        n = int(rng.integers(8, 25))
        queue.submit(Request(
            tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 17)), arrival=now, rid=i))
    eng = ContinuousBatcher(
        params, cfg, queue,
        BatcherConfig(max_slots=4, page_size=8, n_pages=24, max_seq=48),
        seed=engine_seed)
    t0 = time.perf_counter()
    comps = eng.run()
    dt = time.perf_counter() - t0
    stats = eng.memory_stats()
    toks = sum(len(c.tokens) for c in comps)
    say(lines, f"engine: {len(comps)} reqs / {toks} tokens in {eng.steps} "
               f"fused steps ({dt:.2f}s incl. compile)")
    say(lines, f"  peak KV pages {stats['peak_pages']} vs static-equivalent "
               f"{stats['static_equiv_pages']} "
               f"(reclaimed {stats['reclaimed']} behind the window)")
    for c in comps[:3]:
        say(lines, f"  rid={c.rid} wait={c.queue_wait:.1f} steps "
                   f"latency={c.latency:.1f} steps "
                   f"finished_by={c.finished_by}")
    return eng


def failure_path(params, cfg, rng, engine_seed, lines) -> ContinuousBatcher:
    """Part 3: the same engine shape, hostile inputs: one request with a
    deadline it cannot meet, one with a token id outside the vocab, and a
    seeded fault schedule that fails the fused step twice in round 2
    (both replayed from host state — output unchanged).  Returns the
    drained engine."""
    queue = RequestQueue()
    good = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    bad = good.copy()
    bad[3] = cfg.vocab_size + 17          # quarantined at admission
    queue.submit(Request(tokens=good, max_new_tokens=8, arrival=0.0, rid=8))
    queue.submit(Request(tokens=bad, max_new_tokens=8, arrival=0.0, rid=9))
    queue.submit(Request(tokens=good.copy(), max_new_tokens=8,
                         arrival=0.0, deadline=1.0,
                         rid=10))        # expires mid-decode
    eng = ContinuousBatcher(
        params, cfg, queue,
        BatcherConfig(max_slots=2, page_size=8, n_pages=24, max_seq=48),
        seed=engine_seed, faults=FaultSchedule(transient={2: 2}))
    comps = eng.run()
    say(lines, "failure semantics:")
    for c in comps:
        say(lines, f"  rid={c.rid} status={c.status} tokens={len(c.tokens)} "
                   f"preemptions={c.preemptions}")
    say(lines, f"  counters: {eng.fault_stats()}")
    return eng


def run(device="cuda", params=None, prompts=None, seed: int = 0) -> dict:
    """The three parts on recurrentgemma-9b's smoke config: weights
    (``params``, a stacked tree) and prompts (``prompts``, (4, 24) ids)
    drawn on the CPU from streams of ``seed`` unless given; the requests
    from ``np.random.default_rng(seed)``, in the reference's order (rids
    0 to 10, as a fresh reference process numbers them)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    dev = resolve_device(device)
    cfg = get_smoke_config(ARCH)
    # independent streams for weights, prompts, and sampling — reusing
    # one seed would correlate the prompt ids with the weight init
    s_params, s_prompts, s_sample, s_engine = (
        int(ss.generate_state(1, np.uint64)[0] % 2**63)
        for ss in np.random.SeedSequence(seed).spawn(4))
    if params is None:
        params = lm.init_params(cfg, torch.Generator().manual_seed(s_params),
                                device="cpu")
    params = tree_map(lambda t: t.to(dev), params)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab_size, (BATCH, PROMPT_LEN),
            generator=torch.Generator().manual_seed(s_prompts))
    prompts = torch.tensor(np.array(prompts), dtype=torch.int64, device=dev)

    lines = []
    with torch.no_grad():
        static = static_path(params, cfg, prompts, s_sample, lines)
        rng = np.random.default_rng(seed)
        engine = engine_path(params, cfg, rng, s_engine, lines)
        failure = failure_path(params, cfg, rng, s_engine, lines)
    return {"lines": lines, "cfg": cfg, "params": params, "prompts": prompts,
            "sample_seed": s_sample, "static": static, "engine": engine,
            "failure": failure}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
