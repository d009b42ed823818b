"""Synthetic serving traffic for the continuous batcher: the reference
serving bench's fixed-seed Poisson arrival process on the step clock and
its worst-case page pool (``benchmarks/serve_bench.py:71-102``), kept
here so that every caller of the port's engine builds them one way."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.serve.paged_cache import pages_for
from repro_torch.serve.queue import Request


def poisson_requests(vocab: int, seed: int, *, n_req: int, rate: float,
                     prompt: Tuple[int, int], new: Tuple[int, int],
                     request=Request) -> list:
    """``n_req`` requests arriving as a Poisson process of ``rate`` a
    round, prompts of ``prompt`` tokens and ``new`` new tokens (inclusive
    ranges), ``rid = i``; one ``default_rng(seed)`` stream drawn in the
    bench's order.  ``request`` is the class to build (another package's
    ``Request`` with the same fields, in parity tests)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_req))
    prompt_lens = rng.integers(prompt[0], prompt[1] + 1, n_req)
    max_news = rng.integers(new[0], new[1] + 1, n_req)
    return [request(tokens=rng.integers(0, vocab, int(prompt_lens[i]))
                    .astype(np.int32), max_new_tokens=int(max_news[i]),
                    arrival=float(arrivals[i]), rid=i)
            for i in range(n_req)]


def worst_pool(reqs: Sequence[Request], max_slots: int,
               page_size: int) -> int:
    """The pool that never runs short under global attention: the
    ``max_slots`` largest footprints (prompt + new tokens), plus the dead
    page and one spare."""
    foots = [pages_for(r.prompt_len + r.max_new_tokens, page_size)
             for r in reqs]
    return sum(sorted(foots)[-max_slots:]) + 2
