"""Continuous-batching serving engine over the paged decode path (port of
``repro.serve.batcher``).

One :class:`ContinuousBatcher` owns ``max_slots`` batch slots, a paged KV
state (``models.lm.init_paged_state``), a :class:`~repro_torch.serve.
queue.RequestQueue` and, optionally, a plan-cached
:class:`~repro_torch.serve.engine.SparseLogitHead`.  Each scheduling
round (:meth:`step`):

1. **Expire / shed**: in-flight slots past their ``deadline`` retire with
   ``status="deadline_exceeded"``; queued requests past theirs are shed
   before admission.
2. **Admit**: while a ready request, a free slot and enough KV pages
   exist, run a batch-1 prefill (``engine.jitted_prefill``), write its
   caches into the slot's pages (in place) and sample the first token.
   Malformed prompts (token ids outside ``[0, vocab_size)``) are
   quarantined at the door (``status="rejected"``).  When pages run short
   the engine **preempts** the lowest-progress slot: its pages are freed
   and it re-enters the queue carrying its generated tokens, generator
   and timestamps, so resume is a re-prefill over prompt + generated.
3. **Decode**: one fused ``lm.decode_step_paged`` over all ``max_slots``
   rows, scored by the head when there is one (free slots ride along
   writing into the dead page, so every step has the same shapes);
   per-slot positions let slots sit at different depths.  On the card
   the step and the head are one CUDA graph, captured on the engine's
   second step and replayed after it (``serve.graphs.StepGraph``); under
   a bound mesh of several cards the eager step runs
   (``engine.captured``).  The
   call sits inside a **bounded-retry wrapper**: an injected
   :class:`~repro_torch.serve.faults.TransientStepError` is raised before
   the step runs, so the pool (updated in place by a step) is untouched
   and a replay is exact; after ``max_retries`` the round degrades to the
   static per-request path (``engine.complete_static``).
4. **Sample / retire**: per-slot sampling, EOS / length retirement, a
   **non-finite-logits guard** (a slot whose logits are NaN / inf over
   the real vocabulary retires with ``status="error"``; co-resident slots
   are untouched) and page freeing.

Differences from the reference, on purpose:

* **Randomness.** Each request draws from its own ``torch.Generator`` on
  the parameters' device, seeded from ``(seed, rid)`` only (the reference
  folds the rid into a ``jax.random`` key), so its draws do not depend on
  the rest of the batch.  The generator travels with a preempted request
  (``Request.resume_key``) and into ``complete_static(generator=…)`` on a
  fallback drain.  Greedy decoding matches the reference.
* **State.** The page pool, and the recurrent layers' per-slot rows, are
  updated in place by the prefill scatter and by each fused step; the
  reference swaps in functional copies.
* **Compiled steps.** The reference jits the fused step
  (``jitted_decode_step``) and the head apart; here the fused step and
  the head are captured together as one CUDA graph on the card, fed by
  one copy of (tokens | pos | table) into its static buffer.  Sampling
  and fault injection stay outside it, as outside the reference's jitted
  step.  The admission prefill goes through ``jitted_prefill`` and runs
  eagerly.
* **Host syncs.** A fused step copies its host inputs (tokens, positions,
  block table) to the device in one copy and brings back, in one copy,
  each row's token, finiteness flag (and entropy), sampled on the
  device: the logits never leave the card.  A poison fault is written
  into a copy of the logits, never into the state.

Failure injection is deterministic (a
:class:`~repro_torch.serve.faults.FaultSchedule` keys every fault on the
round counter).  MoE configs are served but capacity couples the rows of
a batch, so their tokens may differ from a request served alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serve.engine import (SamplingConfig, SparseLogitHead,
                                      captured, complete_static,
                                      jitted_decode_step,
                                      jitted_prefill, sample_token,
                                      token_entropy)
from repro_torch.serve.faults import FaultSchedule, TransientStepError
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.paged_cache import (DEAD_PAGE, PageAllocator,
                                           assert_paged_memory_bound,
                                           make_table, pages_for,
                                           reclaimable_pages,
                                           scatter_prefill_state)
from repro_torch.serve.queue import (STATUS_DEADLINE, STATUS_ERROR,
                                     STATUS_REJECTED, Completion, Request,
                                     RequestQueue)


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_slots: int = 8           # fused-step batch width
    page_size: int = 8           # tokens per KV page
    n_pages: int = 64            # physical pool size (incl. dead page 0)
    max_seq: int = 128           # per-request prompt + new-token cap
    collect_entropy: bool = False
    max_retries: int = 2         # fused-step replays before degrading
    preempt: bool = True         # evict lowest-progress slot when pages
    #                              run short (False = head-of-line block)

    @property
    def max_pages(self) -> int:  # block-table width per slot
        return -(-self.max_seq // self.page_size)


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: List[int]
    pos: int                     # next write position (tokens so far)
    pending: int                 # last sampled token, not yet fed
    out: List[int]
    generator: torch.Generator   # the request's own draw stream
    t_admit: float
    t_first: float
    steps: int = 0
    pages_reclaimed: int = 0
    entropy: List[float] = dataclasses.field(default_factory=list)


def request_generator(seed: int, rid: int, device) -> torch.Generator:
    """The draw stream of request ``rid`` in an engine seeded ``seed``: a
    generator on ``device`` seeded from ``(seed, rid)`` alone."""
    s = np.random.SeedSequence((int(seed), int(rid))).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


class ContinuousBatcher:
    """The serving engine.  See the module docstring for the step
    anatomy.  ``seed`` takes the place of the reference's ``key``."""

    def __init__(self, params, cfg: ModelConfig, queue: RequestQueue,
                 bcfg: BatcherConfig = BatcherConfig(),
                 sampling: SamplingConfig = SamplingConfig(),
                 head: Optional[SparseLogitHead] = None,
                 seed: int = 0,
                 faults: Optional[FaultSchedule] = None):
        if queue.max_seq is None:
            queue.max_seq = bcfg.max_seq
        self.params = params
        self.cfg = cfg
        self.queue = queue
        self.bcfg = bcfg
        self.sampling = sampling
        self.head = head
        self.seed = int(seed)
        self.faults = faults
        self.device = params["embed_tokens"].device

        self.needs_kv = lm.needs_kv_pages(cfg)
        self.horizon = lm.history_horizon(cfg)
        self.allocator = PageAllocator(bcfg.n_pages, bcfg.page_size)
        self.state = lm.init_paged_state(
            cfg, bcfg.max_slots, bcfg.n_pages, bcfg.page_size,
            bcfg.max_pages, device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * bcfg.max_slots
        self._step_fn = jitted_decode_step(cfg, paged=True,
                                           return_hidden=head is not None)
        # the fused step and the head, captured as one graph on the card
        self.graph = StepGraph(f"the fused step of {cfg.name}")
        self.completions: List[Completion] = []
        self.steps = 0
        self.rounds = 0              # step() calls: the fault-clock key
        self.occupancy_sum = 0       # Σ live slots per fused step
        self.admitted = 0            # admissions incl. preemption resumes
        self.pages_reclaimed = 0     # freed behind the window horizon
        # --- failure-semantics counters (all deterministic) ---
        self.preemptions = 0         # slots evicted for page pressure
        self.sheds = 0               # queued requests shed past deadline
        self.expired = 0             # in-flight deadline retirements
        self.quarantined = 0         # malformed prompts rejected at door
        self.errors = 0              # non-finite-logits retirements
        self.retries = 0             # fused-step replays that happened
        self.fallbacks = 0           # rounds degraded to the static path
        self._alloc_denied = False   # fault-injected exhaustion, per round

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _prompt_pages(self, req: Request) -> int:
        """Pages a (re-)prefill must allocate: the prompt for a fresh
        request; prompt + generated less the leading pages already behind
        the attention horizon for a resumed one."""
        if not self.needs_kv:
            return 0
        n_logical = pages_for(req.total_len, self.bcfg.page_size)
        if not req.generated:
            return n_logical
        dead = min(reclaimable_pages(req.total_len, self.horizon,
                                     self.bcfg.page_size), n_logical)
        return n_logical - dead

    def _validate_tokens(self, req: Request) -> bool:
        toks = req.tokens
        return bool(((toks >= 0) & (toks < self.cfg.vocab_size)).all())

    def try_admit(self, now: float) -> int:
        """Admit every ready request a slot and pages can take; returns
        how many were admitted.  Sheds expired queue entries first,
        quarantines malformed prompts and preempts for pages."""
        for req in self.queue.shed_expired(now):
            self.sheds += 1
            self._complete_unstarted(req, STATUS_DEADLINE, now)
        n = 0
        while True:
            req = self.queue.peek_ready(now)
            if req is None:
                break
            if not self._validate_tokens(req):
                # out-of-range ids never reach prefill, where they would
                # index the embedding table out of bounds
                self.queue.pop()
                self.quarantined += 1
                self._complete_unstarted(req, STATUS_REJECTED, now)
                continue
            slot_id = self.free_slot()
            if slot_id is None:
                break
            n_pp = self._prompt_pages(req)
            # reserve one decode page beyond the prompt so the first
            # fused step can never die on an empty pool mid-flight
            if self.needs_kv and not (not self._alloc_denied
                                      and self.allocator.can_alloc(n_pp + 1)):
                if self._alloc_denied:
                    break        # freeing pages cannot satisfy a denial
                if not self._try_preempt(n_pp + 1, now):
                    break        # nothing evictable would make it fit
                slot_id = self.free_slot()
            self.queue.pop()
            self._admit(req, slot_id, n_pp, now)
            n += 1
        return n

    def _try_preempt(self, need: int, now: float) -> bool:
        """Evict the lowest-progress slot (tokens generated; ties: the
        youngest request, largest rid, yields first) when its pages make
        the admission fit; returns whether it did."""
        if not self.bcfg.preempt:
            return False
        victims = [(len(s.out), -s.req.rid, i)
                   for i, s in enumerate(self.slots) if s is not None]
        if not victims:
            return False
        _, _, vid = min(victims)
        victim = self.slots[vid]
        freeable = sum(1 for p in victim.pages if p != DEAD_PAGE)
        if self.allocator.free_pages() + freeable < need:
            return False
        self._preempt(vid, now)
        return True

    def _preempt(self, slot_id: int, now: float) -> None:
        """Evict a slot: free its pages and requeue its request with what
        resume needs (generated tokens, generator, first timestamps)."""
        slot = self.slots[slot_id]
        req = slot.req
        live = [p for p in slot.pages if p != DEAD_PAGE]
        if live:
            self.allocator.free(live)
        req.generated = list(slot.out)
        req.resume_key = slot.generator
        req.preemptions += 1
        req.t_admit0 = slot.t_admit
        req.t_first0 = slot.t_first
        req.steps0 = slot.steps
        self.slots[slot_id] = None
        self.queue.requeue(req)
        self.preemptions += 1

    def _admit(self, req: Request, slot_id: int, n_pp: int,
               now: float) -> None:
        resumed = bool(req.generated)
        ctx = (np.concatenate([req.tokens,
                               np.asarray(req.generated, np.int32)])
               if resumed else req.tokens)
        total = int(ctx.size)
        pages = self.allocator.alloc(n_pp) if n_pp else []
        if resumed and self.needs_kv:
            # leading logical pages already behind the horizon were not
            # allocated: they map to the dead page, never read again
            dead = pages_for(total, self.bcfg.page_size) - n_pp
            pages = [DEAD_PAGE] * dead + pages
        padded_len = len(pages) * self.bcfg.page_size
        tokens = torch.from_numpy(ctx.astype(np.int64))[None].to(self.device)
        prefill = jitted_prefill(self.cfg, max(padded_len, total),
                                 return_hidden=self.head is not None)
        out, pstate = prefill(self.params, batch={"tokens": tokens})
        logits = self.head(out) if self.head is not None else out
        scatter_prefill_state(self.state, pstate, slot_id, pages,
                              self.bcfg.page_size)

        gen = (req.resume_key if req.resume_key is not None
               else request_generator(self.seed, req.rid, self.device))
        slot = _Slot(req=req, pages=pages, pos=total,
                     pending=0, out=list(req.generated), generator=gen,
                     t_admit=(req.t_admit0 if resumed else now),
                     t_first=(req.t_first0 if resumed else now),
                     steps=req.steps0)
        reason = self._take(slot, self._draw(logits[:, -1], [gen])[0])
        self.slots[slot_id] = slot
        self.admitted += 1
        if reason is not None:       # eos/length/error on the first token
            if reason == STATUS_ERROR:
                self.errors += 1
            self._retire(slot_id, reason, now)

    # ------------------------------------------------------------------
    # sampling / retirement
    # ------------------------------------------------------------------

    def _draw(self, rows: torch.Tensor,
              generators: Sequence[Optional[torch.Generator]]) -> np.ndarray:
        """Sample one token for each row of ``rows`` (n, V_padded) on
        its device, row ``j`` from ``generators[j]`` (``None``: a free
        slot's row, drawn from no one's stream).  Returns a host ``(n, 2)``
        array, or ``(n, 3)`` with ``collect_entropy``: token, whether the
        row is finite over the real vocabulary, entropy, in one copy (the
        only device read).  A non-finite row draws from zeros instead; its
        token is never used."""
        v = self.cfg.vocab_size
        finite = torch.isfinite(rows[:, :v]).all(dim=-1)
        safe = rows.masked_fill(~finite[:, None], 0.0)
        if self.sampling.temperature <= 0.0:
            toks = sample_token(safe, None, self.sampling, v)
        else:
            toks = torch.cat([
                sample_token(safe[j:j + 1], g, self.sampling, v)
                if g is not None else finite.new_zeros(1, dtype=torch.long)
                for j, g in enumerate(generators)])
        cols = [toks.double(), finite.double()]
        if self.bcfg.collect_entropy:
            cols.append(token_entropy(safe, v).double())
        return torch.stack(cols, dim=1).cpu().numpy()

    def _take(self, slot: _Slot, drawn: np.ndarray) -> Optional[str]:
        """Apply one drawn row (``_draw``) to a slot; returns a finish
        reason or None.  A non-finite row is the quarantine signal: no
        token is taken and the slot retires with ``status="error"``."""
        if not drawn[1]:
            return STATUS_ERROR
        tok = int(drawn[0])
        slot.out.append(tok)
        if self.bcfg.collect_entropy:
            slot.entropy.append(float(drawn[2]))
        slot.pending = tok
        req = slot.req
        if req.eos_id >= 0 and tok == req.eos_id:
            return "eos"
        if len(slot.out) >= req.max_new_tokens:
            return "length"
        return None

    def _retire(self, slot_id: int, reason: str, now: float) -> None:
        slot = self.slots[slot_id]
        self.completions.append(Completion(
            rid=slot.req.rid, prompt_len=slot.req.prompt_len,
            tokens=list(slot.out), finished_by=reason,
            arrival=slot.req.arrival, t_admit=slot.t_admit,
            t_first_token=slot.t_first, t_done=now, steps=slot.steps,
            status=reason, preemptions=slot.req.preemptions))
        live = [p for p in slot.pages if p != DEAD_PAGE]
        if live:
            self.allocator.free(live)
        self.slots[slot_id] = None

    def _complete_unstarted(self, req: Request, status: str,
                            now: float) -> None:
        """Completion for a request that never (re)gained a slot: shed
        past deadline or quarantined.  A preempted request shed while
        waiting keeps the tokens it had already generated."""
        t_admit = req.t_admit0 if req.t_admit0 is not None else now
        t_first = req.t_first0 if req.t_first0 is not None else now
        self.completions.append(Completion(
            rid=req.rid, prompt_len=req.prompt_len,
            tokens=list(req.generated), finished_by=status,
            arrival=req.arrival, t_admit=t_admit, t_first_token=t_first,
            t_done=now, steps=req.steps0, status=status,
            preemptions=req.preemptions))

    def _reclaim_window_pages(self, slot: _Slot) -> None:
        """Free pages every layer's read horizon has moved past; their
        table entries fall back to the dead page.  Unbounded-horizon
        configs never reclaim."""
        r = reclaimable_pages(slot.pos, self.horizon, self.bcfg.page_size)
        for j in range(min(r, len(slot.pages))):
            if slot.pages[j] != DEAD_PAGE:
                self.allocator.free([slot.pages[j]])
                slot.pages[j] = DEAD_PAGE
                slot.pages_reclaimed += 1
                self.pages_reclaimed += 1

    # ------------------------------------------------------------------
    # the fused step
    # ------------------------------------------------------------------

    def live(self) -> int:
        return sum(s is not None for s in self.slots)

    def _ensure_decode_page(self, slot_id: int, now: float) -> None:
        """Allocate the page this step's token lands on (logical page
        ``pos // P``) if the slot has not grown there yet.  When the pool
        is dry, lower-progress other slots are preempted; with no victim
        the allocator raises (a pool too small for one sequence is a
        capacity bug)."""
        slot = self.slots[slot_id]
        if not self.needs_kv:
            return
        need = slot.pos // self.bcfg.page_size + 1
        while len(slot.pages) < need:
            if not self.allocator.can_alloc(1) and self.bcfg.preempt:
                others = [(len(s.out), -s.req.rid, i)
                          for i, s in enumerate(self.slots)
                          if s is not None and i != slot_id
                          and any(p != DEAD_PAGE for p in s.pages)]
                if others:
                    self._preempt(min(others)[2], now)
            slot.pages.extend(self.allocator.alloc(1))

    def _retire_expired(self, now: float) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.req.expired(now):
                self.expired += 1
                self._retire(i, STATUS_DEADLINE, now)

    def _fallback_drain(self, now: float) -> None:
        """After the fused step's retry budget is gone, every live slot
        finishes on the static per-request path (``complete_static``:
        prefill over prompt + generated, per-token decode, same head,
        same generator).  The engine goes on normally next round."""
        self.fallbacks += 1
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            req = slot.req
            ctx = (np.concatenate([req.tokens,
                                   np.asarray(slot.out, np.int32)])
                   if slot.out else req.tokens)
            new_toks, reason, slot.generator = complete_static(
                self.params, self.cfg, ctx,
                req.max_new_tokens - len(slot.out),
                sampling=self.sampling, generator=slot.generator,
                eos_id=req.eos_id, head=self.head)
            slot.out.extend(new_toks)
            if reason == STATUS_ERROR:
                self.errors += 1
            self._retire(i, reason, now)

    def _fused(self, caches, packed: torch.Tensor):
        """The fused step on ``packed`` = (tokens | pos | table) per slot,
        int32 on the device: the eager paged step, then the head, which
        scores the slots as the ``max_slots`` columns of one product (the
        reference: one batch each), so its weight is read once a step.
        Returns the logits ``(max_slots, 1, V)``, the new ``pos`` and the
        table."""
        state = dict(caches, pos=packed[:, 1], table=packed[:, 2:])
        out, new_state = self._step_fn.eager(self.params, state,
                                             packed[:, :1])
        if self.head is not None:
            out = self.head(out.transpose(0, 1)).transpose(0, 1)
        return out, new_state["pos"], new_state["table"]

    def _decode(self, host: np.ndarray):
        """The fused step on ``host`` = (tokens | pos | table) per slot,
        int32, copied to the device at once (on one card into the
        graph's static buffer, then the graph replays; on the CPU or a
        mesh of several cards the eager step).  Returns the logits
        ``(max_slots, 1, V)`` and the new state."""
        caches = {k: v for k, v in self.state.items()
                  if k not in ("pos", "table")}
        packed = torch.from_numpy(host)
        if captured(self.device):
            out, pos, table = self.graph(
                lambda feeds: self._fused(caches, feeds["packed"]),
                {"packed": packed}, (self.params, caches, self.head),
                self.device)
        else:
            out, pos, table = self._fused(caches, packed.to(self.device))
        return out, dict(self.state, pos=pos, table=table)

    def step(self, now: float = 0.0) -> List[Completion]:
        """One scheduling round: expire, admit, fused-decode (with
        bounded retry), sample, retire.  Returns the requests that
        completed during this round."""
        before = len(self.completions)
        rnd = self.rounds
        self.rounds += 1
        self._alloc_denied = (self.faults.alloc_denied(rnd)
                              if self.faults is not None else False)
        self._retire_expired(now)
        self.try_admit(now)
        if self.live() == 0:
            return self.completions[before:]

        # grow write pages BEFORE assembling the batch: growth may evict a
        # co-resident slot, which must not decode as a ghost into freed
        # pages
        for i in range(self.bcfg.max_slots):
            if self.slots[i] is not None:
                self._ensure_decode_page(i, now)
        if self.live() == 0:
            return self.completions[before:]

        host = np.zeros((self.bcfg.max_slots, 2 + self.bcfg.max_pages),
                        np.int32)
        pages: List[List[int]] = [[] for _ in range(self.bcfg.max_slots)]
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            host[i, 0] = slot.pending
            host[i, 1] = slot.pos
            pages[i] = slot.pages
        host[:, 2:] = make_table(pages, self.bcfg.max_pages)

        # bounded retry: the injected failure is raised before the step
        # runs, so the in-place pool is untouched and a replay is exact.
        # Only TransientStepError is retried: real bugs propagate.
        inject = (self.faults.transient_failures(rnd)
                  if self.faults is not None else 0)
        attempts = 0
        while True:
            try:
                if attempts < inject:
                    raise TransientStepError(
                        f"injected transient failure (round {rnd}, "
                        f"attempt {attempts})")
                logits, new_state = self._decode(host)
                break
            except TransientStepError:
                attempts += 1
                if attempts > self.bcfg.max_retries:
                    self._fallback_drain(now)
                    return self.completions[before:]
                self.retries += 1

        self.state = new_state
        self.steps += 1
        self.occupancy_sum += self.live()

        rows = logits[:, -1]
        psn = (self.faults.poison_slot(rnd)
               if self.faults is not None else None)
        if psn is not None and 0 <= psn < self.bcfg.max_slots \
                and self.slots[psn] is not None:
            rows = rows.clone()              # poison a copy, never state
            rows[psn] = float("nan")
        drawn = self._draw(rows, [s.generator if s is not None else None
                                  for s in self.slots])
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.pos += 1
            slot.steps += 1
            reason = self._take(slot, drawn[i])
            if reason is not None:
                if reason == STATUS_ERROR:
                    self.errors += 1
                self._retire(i, reason, now)
            else:
                self._reclaim_window_pages(slot)
        return self.completions[before:]

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------

    def idle(self) -> bool:
        return self.live() == 0 and self.queue.pending() == 0

    def run(self, max_steps: int = 100_000,
            clock=None) -> List[Completion]:
        """Drive until queue and slots drain.  ``clock`` maps the step
        index to ``now`` (default: the step index itself, the
        deterministic replay clock)."""
        for t in range(max_steps):
            now = float(clock()) if clock is not None else float(t)
            if self.idle():
                break
            self.step(now)
        else:
            raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return self.completions

    def memory_stats(self) -> Dict[str, Any]:
        stats = assert_paged_memory_bound(
            self.allocator, self.bcfg.max_slots, self.bcfg.max_pages)
        stats["page_size"] = self.bcfg.page_size
        stats["reclaimed"] = self.pages_reclaimed
        return stats

    def fault_stats(self) -> Dict[str, int]:
        """The deterministic failure-semantics counters, in the order the
        reference's bench records them."""
        return {"preemptions": self.preemptions,
                "sheds": self.sheds,
                "expired": self.expired,
                "quarantined": self.quarantined,
                "errors": self.errors,
                "retries": self.retries,
                "fallbacks": self.fallbacks}
