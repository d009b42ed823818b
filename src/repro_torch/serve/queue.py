"""Request queue and admission control for the continuous-batching engine
(port of ``repro.serve.queue``).

The queue is the engine's only intake: producers ``submit()`` requests
(non-blocking: a full queue rejects instead of backing up into the
caller), and the engine polls ``peek_ready(now)`` each scheduling round
for requests whose arrival time has come.  Time is whatever clock the
caller uses (wall seconds, or decode-step indices in the deterministic
replay mode); the queue only compares it.

Admission control happens twice:

* at **submit**: depth-bounded (``max_depth``) and shape-bounded
  (``max_seq`` caps prompt + max_new_tokens so a request can never
  outgrow its slot's block table); rejects are counted, never raised;
* at **claim** (in the batcher): a ready request is admitted only when a
  batch slot and enough KV pages for its prompt (plus one decode page)
  are free, else it stays queued, FIFO order preserved.  The batcher
  also sheds queued requests whose ``deadline`` has passed
  (``shed_expired``), quarantines malformed prompts, and ``requeue``-s
  preempted requests.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from collections import deque
from typing import Any, Deque, List, Optional, Sequence

import numpy as np

_rid_counter = itertools.count()

# Completion.status values.  "ok" is reserved for callers that collapse
# the two normal finishes; the engine itself always reports the precise
# reason.
STATUS_OK = "ok"
STATUS_EOS = "eos"                           # sampled its eos_id
STATUS_LENGTH = "length"                     # hit max_new_tokens
STATUS_DEADLINE = "deadline_exceeded"        # shed queued / retired live
STATUS_ERROR = "error"                       # non-finite logits quarantine
STATUS_REJECTED = "rejected"                 # malformed prompt at admission
STATUSES = (STATUS_OK, STATUS_EOS, STATUS_LENGTH, STATUS_DEADLINE,
            STATUS_ERROR, STATUS_REJECTED)


@dataclasses.dataclass
class Request:
    """One generation request.

    ``eos_id`` / ``max_new_tokens`` are per request; ``arrival`` is the
    submit time in the caller's clock units.  ``deadline`` (absolute, same
    clock; ``None`` never expires) is the last instant the request may
    still be served: the engine sheds it from the queue and retires it in
    flight once ``now > deadline``.

    The trailing fields are preemption bookkeeping the engine owns: a
    preempted request re-enters the queue carrying its sampled
    ``generated`` tokens (resume = re-prefill over prompt + generated),
    its sampling generator (``resume_key``, a ``torch.Generator``) and its
    first admit / first-token timestamps, so the eventual
    :class:`Completion` reads as one uninterrupted service span.
    """
    tokens: np.ndarray                   # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1
    arrival: float = 0.0
    deadline: Optional[float] = None
    rid: int = dataclasses.field(
        default_factory=lambda: next(_rid_counter))
    # --- engine-owned resume state (set on preemption) ---
    generated: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    resume_key: Any = None               # the slot's torch.Generator
    t_admit0: Optional[float] = None     # first admission timestamps
    t_first0: Optional[float] = None
    steps0: int = 0                      # fused steps ridden pre-preempt

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.size)

    @property
    def total_len(self) -> int:
        """Context length a (re-)prefill must process: the prompt plus
        any tokens generated before a preemption."""
        return self.prompt_len + len(self.generated)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    @property
    def deadline_or_inf(self) -> float:
        return math.inf if self.deadline is None else self.deadline


@dataclasses.dataclass
class Completion:
    """What the engine hands back when a request retires.

    ``status`` is the failure-semantics verdict (see ``STATUSES``);
    ``finished_by`` mirrors it.  ``preemptions`` counts how many times
    the request was evicted and resumed before finishing.
    """
    rid: int
    prompt_len: int
    tokens: List[int]                    # sampled tokens, incl. final eos
    finished_by: str                     # == status
    arrival: float
    t_admit: float
    t_first_token: float
    t_done: float
    steps: int                           # fused decode steps it rode
    status: str = STATUS_OK
    preemptions: int = 0

    def __post_init__(self):
        if self.status == STATUS_OK and self.finished_by in STATUSES:
            self.status = self.finished_by
        if self.status not in STATUSES:
            raise ValueError(f"unknown status {self.status!r}")

    @property
    def ok(self) -> bool:
        return self.status in (STATUS_OK, STATUS_EOS, STATUS_LENGTH)

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.arrival


class RequestQueue:
    """Depth-bounded FIFO with arrival-time gating and deadline sheds."""

    def __init__(self, max_depth: int = 256,
                 max_seq: Optional[int] = None):
        self.max_depth = int(max_depth)
        self.max_seq = max_seq
        self._q: Deque[Request] = deque()
        self.accepted = 0
        self.rejected_depth = 0
        self.rejected_shape = 0
        self.shed = 0                    # deadline-expired before admission
        self.requeued = 0                # preemption round trips

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: Request) -> bool:
        """Non-blocking admission: False = rejected (full / too long)."""
        if (self.max_seq is not None
                and req.prompt_len + req.max_new_tokens > self.max_seq):
            self.rejected_shape += 1
            return False
        if len(self._q) >= self.max_depth:
            self.rejected_depth += 1
            return False
        self._q.append(req)
        self.accepted += 1
        return True

    def submit_all(self, reqs: Sequence[Request]) -> int:
        return sum(self.submit(r) for r in reqs)

    def requeue(self, req: Request) -> None:
        """Return a preempted request to the back of the queue.  Never
        depth-rejected: it was accepted once and its slot's memory has
        just been released."""
        self._q.append(req)
        self.requeued += 1

    def shed_expired(self, now: float) -> List[Request]:
        """Remove every queued request whose deadline has passed
        (anywhere in the queue: an expired head must not block live
        requests behind it).  Returns them for the caller to complete
        with ``status="deadline_exceeded"``."""
        if not self._q:
            return []
        expired = [r for r in self._q if r.expired(now)]
        if expired:
            self._q = deque(r for r in self._q if not r.expired(now))
            self.shed += len(expired)
        return expired

    def peek_ready(self, now: float) -> Optional[Request]:
        """Head request whose arrival time has come, without removing."""
        if self._q and self._q[0].arrival <= now:
            return self._q[0]
        return None

    def pop(self) -> Request:
        return self._q.popleft()

    def pending(self) -> int:
        return len(self._q)

    def next_arrival(self) -> Optional[float]:
        return self._q[0].arrival if self._q else None
