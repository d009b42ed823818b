"""Deterministic fault injection for the serving engine (port of
``repro.serve.faults``; host numpy only, so a schedule equals the
reference's field by field).

A :class:`FaultSchedule` is a pure function from the engine's
scheduling-round index to what breaks that round, fixed at construction,
so the failure-semantics layer (deadlines, preemption, quarantine,
retry) is tested as arithmetic on the virtual step clock.  Fault kinds,
each keyed by the round counter the engine increments at the top of
every :meth:`~repro_torch.serve.batcher.ContinuousBatcher.step`:

* **transient step failures**: ``transient[round] = k`` makes the first
  ``k`` attempts of that round's fused decode step raise
  :class:`TransientStepError` (before the step runs).  ``k`` ≤
  ``max_retries`` is absorbed by the bounded retry, a larger ``k``
  degrades the round to the static per-request path;
* **NaN-logit poisoning**: ``poison[round] = slot`` overwrites that
  slot's row of a copy of the logits with NaN; the engine's non-finite
  guard retires the slot with ``status="error"``, co-resident slots are
  unaffected;
* **allocator denial**: rounds in ``deny_alloc`` refuse admission
  allocations; freeing pages cannot satisfy a denial, so the engine
  blocks admission instead of preempting;
* **malformed requests**: ``malformed`` holds workload request indices
  whose prompts :func:`apply_malformed` corrupts with out-of-range token
  ids; admission quarantines them (``status="rejected"``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence

import numpy as np


class TransientStepError(RuntimeError):
    """A decode step failed in a way worth retrying (injected).  The
    engine's retry wrapper catches exactly this type."""


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A deterministic map from scheduling round to injected faults.
    The default schedule injects nothing; equality is field-wise."""

    transient: Dict[int, int] = dataclasses.field(default_factory=dict)
    poison: Dict[int, int] = dataclasses.field(default_factory=dict)
    deny_alloc: FrozenSet[int] = frozenset()
    malformed: FrozenSet[int] = frozenset()
    seed: Optional[int] = None     # provenance only (sample() stamps it)

    def transient_failures(self, rnd: int) -> int:
        """How many consecutive attempts of round ``rnd``'s fused step
        fail before one succeeds."""
        return int(self.transient.get(rnd, 0))

    def poison_slot(self, rnd: int) -> Optional[int]:
        """Slot whose logits are NaN-poisoned after round ``rnd``'s fused
        step (None: no poisoning this round)."""
        return self.poison.get(rnd)

    def alloc_denied(self, rnd: int) -> bool:
        """Does the allocator refuse admission allocations this round?"""
        return rnd in self.deny_alloc

    def is_empty(self) -> bool:
        return not (self.transient or self.poison or self.deny_alloc
                    or self.malformed)

    @classmethod
    def sample(cls, seed: int, n_rounds: int, *,
               p_transient: float = 0.0, max_burst: int = 1,
               p_poison: float = 0.0, max_slot: int = 0,
               p_deny: float = 0.0,
               n_requests: int = 0, p_malformed: float = 0.0
               ) -> "FaultSchedule":
        """Draw a schedule from a seed: same seed, same schedule.

        ``p_*`` are per-round (per-request for ``p_malformed``)
        probabilities; ``max_burst`` bounds a transient fault's
        consecutive failures; ``max_slot`` is the exclusive upper bound of
        poisoned slot ids.
        """
        rng = np.random.default_rng(seed)
        transient: Dict[int, int] = {}
        poison: Dict[int, int] = {}
        deny: List[int] = []
        # one draw stream, consumed in a fixed field order: determinism
        # does not depend on which probabilities are zero
        for rnd in range(n_rounds):
            if rng.random() < p_transient:
                transient[rnd] = int(rng.integers(1, max_burst + 1))
            if rng.random() < p_poison and max_slot > 0:
                poison[rnd] = int(rng.integers(0, max_slot))
            if rng.random() < p_deny:
                deny.append(rnd)
        malformed = [i for i in range(n_requests)
                     if rng.random() < p_malformed]
        return cls(transient=transient, poison=poison,
                   deny_alloc=frozenset(deny),
                   malformed=frozenset(malformed), seed=seed)


def corrupt_tokens(tokens: np.ndarray, vocab_size: int,
                   rng: np.random.Generator) -> np.ndarray:
    """A copy of ``tokens`` with one deterministic out-of-range id (the
    canonical poison prompt, which admission must reject)."""
    out = np.array(tokens, np.int32, copy=True)
    pos = int(rng.integers(0, out.size))
    out[pos] = np.int32(vocab_size + int(rng.integers(1, 7)))
    return out


def apply_malformed(reqs: Sequence, schedule: FaultSchedule,
                    vocab_size: int, seed: int = 0) -> int:
    """Corrupt the prompts of ``reqs`` at ``schedule.malformed`` indices
    (in place); returns how many were corrupted."""
    rng = np.random.default_rng(seed)
    n = 0
    for i in sorted(schedule.malformed):
        if i < len(reqs):
            reqs[i].tokens = corrupt_tokens(reqs[i].tokens, vocab_size,
                                            rng)
            n += 1
    return n
