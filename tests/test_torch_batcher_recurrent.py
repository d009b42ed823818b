"""Port parity: the continuous batcher (``repro_torch.serve.batcher``) on
the recurrent families against ``repro.serve.batcher`` on the CPU.

recurrentgemma-9b keeps K/V pages for its local-attention layers and a
row of RG-LRU state per slot; mamba2-2.7b keeps SSM state only (no
pages).  Both packages serve the same requests from the same weights
(the reference's init, carried across); every ``Completion`` and counter
must be equal, and greedy tokens equal ``generate`` of the request
alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.serve import SamplingConfig, generate
from repro_torch.serve.paged_cache import pages_for
from test_torch_batcher import load_models, run_both

RECURRENT = ["recurrentgemma-9b", "mamba2-2.7b"]


@pytest.fixture(scope="module", params=RECURRENT)
def models(request):
    return load_models(request.param)


def _prompts(cfg, seed, b, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, n))


def _generate(params, cfg, prompts, max_new):
    out, _ = generate(params, cfg, {"tokens": torch.from_numpy(
        np.asarray(prompts))}, SamplingConfig(max_new_tokens=max_new))
    return out.tolist()


@pytest.mark.timeout(120)
def test_continuous_batching_matches_generate(models):
    """The reference's case on both families: request 2 joins at round 3
    while 0 and 1 decode, and each request's greedy tokens equal
    ``generate`` (alone, or the two first as one batch)."""
    cfg_ref, cfg, params_ref, params = models
    prompt_len, max_new, page = 8, 8, 4
    prompts = _prompts(cfg, 3, 3, prompt_len)

    def make(mod):
        reqs = [mod.Request(tokens=prompts[i], max_new_tokens=max_new,
                            arrival=a, rid=i)
                for i, a in enumerate((0.0, 0.0, 3.0))]
        return reqs, mod.BatcherConfig(max_slots=4, page_size=page,
                                       n_pages=32,
                                       max_seq=prompt_len + max_new), None

    eng = run_both(models, make)
    comps = {c.rid: c for c in eng.completions}
    assert comps[2].t_admit == 3.0
    assert comps[2].tokens == _generate(params, cfg, prompts[2:3],
                                        max_new)[0]
    both = _generate(params, cfg, prompts[:2], max_new)
    assert [comps[0].tokens, comps[1].tokens] == both
    if not eng.needs_kv:
        assert eng.allocator.total_allocs == 0


@pytest.mark.timeout(120)
def test_a_reused_slot_gives_the_solo_tokens(models):
    """Two slots, three requests: request 2 waits for request 0's slot.
    The admission overwrites the slot's recurrent rows (and pages), so
    request 2 decodes the tokens it decodes alone."""
    cfg_ref, cfg, params_ref, params = models
    prompts = _prompts(cfg, 5, 3, 8)

    def make(mod):
        reqs = [mod.Request(tokens=prompts[i], max_new_tokens=n,
                            arrival=a, rid=i)
                for i, (n, a) in enumerate(((3, 0.0), (9, 0.0), (6, 1.0)))]
        return reqs, mod.BatcherConfig(max_slots=2, page_size=4,
                                       n_pages=16, max_seq=16), None

    eng = run_both(models, make)
    comps = {c.rid: c for c in eng.completions}
    assert comps[2].t_admit > comps[0].t_done - 1 >= 0
    for rid, n in ((0, 3), (1, 9), (2, 6)):
        assert comps[rid].tokens == _generate(params, cfg,
                                              prompts[rid:rid + 1], n)[0]


@pytest.mark.timeout(120)
def test_window_horizon_reclamation_bounds_pool():
    """The reference's case: recurrentgemma decoding far past its window
    (16) reclaims pages behind the horizon, so a pool of 8 pages serves a
    48-token sequence that needs 12, with the tokens of ``generate``."""
    models = load_models("recurrentgemma-9b")
    cfg_ref, cfg, params_ref, params = models
    prompt_len, max_new, page = 8, 40, 4
    prompt = _prompts(cfg, 3, 1, prompt_len)

    def make(mod):
        return ([mod.Request(tokens=prompt[0], max_new_tokens=max_new,
                             rid=0)],
                mod.BatcherConfig(max_slots=2, page_size=page, n_pages=9,
                                  max_seq=prompt_len + max_new), None)

    eng = run_both(models, make)
    assert eng.completions[0].tokens == _generate(params, cfg, prompt,
                                                  max_new)[0]
    stats = eng.memory_stats()
    assert stats["reclaimed"] > 0
    assert stats["peak_pages"] <= pages_for(cfg.window, page) + 2
