"""Serving on the static path: prefill + sampling decode loop, and the
block-sparse logit head (port of ``repro.serve.engine``).  The
continuous batcher over paged decode is :mod:`repro_torch.serve.batcher`;
``complete_static`` is its fallback path.

Randomness: sampled decoding draws from an explicit ``torch.Generator``
on the logits' device.  It cannot reproduce the reference's
``jax.random`` draws; greedy decoding (temperature 0) matches it.

Compiled steps: ``jitted_prefill`` and ``jitted_decode_step`` are the
reference's cached callables, one per key, called as the reference's
are.  A decode callable on the card captures its step once as a CUDA
graph and replays it (:class:`~repro_torch.serve.graphs.StepGraph`: the
first call on a state is eager, the second captures, every later one
replays; the caches are updated in place); on the CPU, and under a
bound mesh whose entries name several cards (:func:`captured`), it runs
the eager step.  Prompt lengths differ request to request, so a prefill
runs eagerly on every device.  ``generate`` and ``complete_static`` go
through both, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels.autotune import auto_plan
from repro_torch.kernels.partition import (PartitionedSpmmPlan,
                                           plan_partitioned_spmm)
from repro_torch.kernels.schedule import (SpmmPlan, SpmmTrainPlan, plan_spmm,
                                          plan_spmm_vjp)
from repro_torch.models import lm
from repro_torch.models.layers import sparse_linear
from repro_torch.serve.graphs import StepGraph, captured


@dataclasses.dataclass(frozen=True)
class SparseLogitHead:
    """Serving-side block-sparse unembedding.  The load-balanced plan is
    built once from the weight's sparsity pattern and reused on every
    step; a call scores ``(B, S, D)`` hidden states in one planned kernel
    launch plus the deterministic slot merge.  ``trainable=True`` builds
    the training plan (``plan_spmm_vjp``), so a call is differentiable in
    the weight's payload and the hidden states through the kernels.

    ``n_shards=D`` partitions the head's block-rows (the vocabulary)
    across ``D`` shards (``kernels.partition``): each scores its slice of
    the vocabulary on B1 and the row-offset merge reassembles the logits,
    on a mesh of cards where ``partition_mesh`` finds one, else one shard
    after another on the hidden states' card.  ``n_col_shards=C`` splits
    the hidden states' tokens into ``C`` column panels."""

    weight: BlockCSR         # (vocab, d_model) block-sparse
    plan: SpmmPlan | SpmmTrainPlan | PartitionedSpmmPlan

    @classmethod
    def build(cls, weight: BlockCSR, *, n_lanes: int = 8,
              chunk: int | None = None, n_shards: int | None = None,
              n_col_shards: int | None = None, trainable: bool = False,
              plan: str | None = None) -> "SparseLogitHead":
        """``plan="auto"`` replaces the hand-tuned knobs with a budgeted
        ``kernels.autotune`` search over the head's pattern (memoized:
        rebuilding a head for a seen pattern never searches again);
        ``n_shards`` then bounds the searched device axis,
        ``n_col_shards`` pins the column split, and ``n_lanes`` /
        ``chunk`` are ignored."""
        if plan is not None:
            if plan != "auto":
                raise ValueError(f"unknown plan {plan!r}; only 'auto' "
                                 f"(or drop it for the hand-tuned knobs)")
            return cls(weight=weight,
                       plan=auto_plan(weight, trainable=trainable,
                                      n_shards=n_shards,
                                      n_col_shards=n_col_shards))
        col = n_col_shards if n_col_shards is not None else 1
        if trainable:
            plan = plan_spmm_vjp(weight, n_lanes=n_lanes, chunk=chunk,
                                 n_shards=n_shards, n_col_shards=n_col_shards)
        elif (n_shards is not None and n_shards > 1) or col > 1:
            plan = plan_partitioned_spmm(
                weight, n_shards=n_shards if n_shards is not None else 1,
                n_lanes=n_lanes, chunk=chunk, n_col_shards=col)
        else:
            plan = plan_spmm(weight, n_lanes=n_lanes, chunk=chunk)
        return cls(weight=weight, plan=plan)

    @property
    def predicted_cycles(self):
        return self.plan.predicted_cycles()

    def __call__(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden: (B, S, D) → logits (B, S, V)."""
        return sparse_linear(self.weight, hidden, plan=self.plan)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0     # 0 → greedy
    top_k: int = 0               # 0 → no top-k filtering
    max_new_tokens: int = 32
    eos_id: int = -1             # -1 → never stop early


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 cfg: SamplingConfig, vocab_size: int) -> torch.Tensor:
    """logits: (B, V_padded) → (B,) int64; padded vocab ids are masked."""
    logits = logits.float()
    mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    logits = logits.masked_fill(~mask, float("-inf"))
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def token_entropy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Per-row softmax entropy over the real vocabulary: (B, V) → (B,)."""
    lg = logits[..., :vocab_size].float()
    probs = torch.softmax(lg, dim=-1)
    return -torch.sum(probs * torch.log(probs + 1e-9), dim=-1)


# --------------------------------------------------------------------------
# the compiled-step cache: one callable per key, as the reference's (its
# jax.jit traces live per callable), so back-to-back generate() calls
# reuse one decode callable and its graph's warm-up
# --------------------------------------------------------------------------

_PREFILL_JIT: Dict[tuple, Any] = {}
_DECODE_JIT: Dict[tuple, Any] = {}


class PrefillStep:
    """``lm.prefill`` for one (cfg, max_seq, return_hidden), called as the
    reference's jitted one: ``fn(params, batch=...)`` → (logits or the
    hidden state, decode state).  It runs eagerly on every device and
    every mesh, one card's or several cards'."""

    def __init__(self, cfg: ModelConfig, max_seq: int, return_hidden: bool):
        self.cfg, self.max_seq = cfg, max_seq
        self.return_hidden = return_hidden

    def __call__(self, params, batch):
        return lm.prefill(params, self.cfg, batch, max_seq=self.max_seq,
                          return_hidden=self.return_hidden)


class DecodeStep:
    """``lm.decode_step`` (``paged``: ``decode_step_paged``) for one cfg,
    called as the reference's jitted one: ``fn(params, state=...,
    tokens=...)`` → (logits or the hidden state, new state).

    On tensors on the CPU, and under a bound mesh of several cards
    (:func:`captured` is false), it runs the eager step.  Otherwise, on
    the card, it runs through :attr:`graph`, fed the tokens and the
    state's ``pos`` (and ``table`` when paged); the caches are updated in
    place, as the eager step updates them.  The state's ``pos`` comes
    back of the kind it went in: an int stays an int."""

    def __init__(self, cfg: ModelConfig, paged: bool, return_hidden: bool):
        self.cfg, self.paged = cfg, paged
        self.return_hidden = return_hidden
        step = "decode_step_paged" if paged else "decode_step"
        self.graph = StepGraph(f"{step} of {cfg.name}")

    def eager(self, params, state, tokens):
        step = lm.decode_step_paged if self.paged else lm.decode_step
        return step(params, self.cfg, state, tokens,
                    return_hidden=self.return_hidden)

    def __call__(self, params, state, tokens):
        if not captured(tokens.device):
            return self.eager(params, state, tokens)
        names = ("pos", "table") if self.paged else ("pos",)
        caches = {k: v for k, v in state.items() if k not in names}

        def fn(feeds):
            out, new = self.eager(
                params, dict(caches, **{k: feeds[k] for k in names}),
                feeds["tokens"])
            return out, new["pos"]

        feeds = {"tokens": tokens, **{k: state[k] for k in names}}
        out, pos = self.graph(fn, feeds, (params, caches), tokens.device)
        if not torch.is_tensor(state["pos"]):
            pos = state["pos"] + 1
        return out, dict(state, pos=pos)


def jitted_prefill(cfg: ModelConfig, max_seq: int, *,
                   return_hidden: bool = False) -> PrefillStep:
    """The cached prefill callable for (cfg, max_seq, return_hidden)."""
    key = (cfg, int(max_seq), bool(return_hidden))
    fn = _PREFILL_JIT.get(key)
    if fn is None:
        fn = _PREFILL_JIT[key] = PrefillStep(cfg, int(max_seq),
                                             bool(return_hidden))
    return fn


def jitted_decode_step(cfg: ModelConfig, *, paged: bool = False,
                       return_hidden: bool = False) -> DecodeStep:
    """The cached decode callable for (cfg, paged, return_hidden): on one
    card, a captured CUDA graph replayed; on the CPU or a mesh of several
    cards, the eager step (see :class:`DecodeStep`)."""
    key = (cfg, bool(paged), bool(return_hidden))
    fn = _DECODE_JIT.get(key)
    if fn is None:
        fn = _DECODE_JIT[key] = DecodeStep(cfg, bool(paged),
                                           bool(return_hidden))
    return fn


def release_graphs() -> None:
    """Drop every cached decode callable's graph and the parameters and
    state it holds (the callables stay cached)."""
    for fn in _DECODE_JIT.values():
        fn.graph.release()


def _default_generator(device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def complete_static(params, cfg: ModelConfig, tokens, max_new: int, *,
                    sampling: SamplingConfig,
                    generator: Optional[torch.Generator] = None,
                    eos_id: int = -1,
                    head: Optional[SparseLogitHead] = None):
    """Finish ONE request on the static path: batch-1 prefill over the
    prompt, then one ``decode_step`` per token, scored by ``head`` when
    given (else the dense ``lm_head``).

    Returns ``(new_tokens, reason, generator)`` with ``reason`` in
    ``("eos", "length", "error")``: the request ends at ``eos_id`` (when
    ≥ 0; ``sampling.eos_id`` is not read, as in the reference), at
    ``max_new`` tokens, or with ``"error"`` on non-finite logits.

    A request is its tokens alone, as in the reference: a model that also
    takes encoder frames or a vision prefix is refused (serve it through
    ``lm.prefill`` / ``lm.decode_step``, or :func:`generate`)."""
    if cfg.n_enc_layers > 0 or cfg.n_patches > 0:
        extra = "enc_frames" if cfg.n_enc_layers > 0 else "vision_embeds"
        raise NotImplementedError(
            f"complete_static takes a request's tokens only; {cfg.name} "
            f"also needs {extra}: use generate, or lm.prefill / "
            f"lm.decode_step")
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    if max_new <= 0:
        return [], "length", generator
    device = params["embed_tokens"].device
    if generator is None:
        generator = _default_generator(device)
    use_head = head is not None
    prefill = jitted_prefill(cfg, tokens.size + max_new,
                             return_hidden=use_head)
    step_fn = jitted_decode_step(cfg, return_hidden=use_head)
    out, state = prefill(params, batch={
        "tokens": torch.from_numpy(tokens)[None].to(device)})
    logits = head(out) if use_head else out
    new_tokens: list = []
    while True:
        row = logits[:, -1]
        if not bool(torch.isfinite(row[:, :cfg.vocab_size]).all()):
            return new_tokens, "error", generator
        tok = int(sample_token(row, generator, sampling, cfg.vocab_size)[0])
        new_tokens.append(tok)
        if eos_id >= 0 and tok == eos_id:
            return new_tokens, "eos", generator
        if len(new_tokens) >= max_new:
            return new_tokens, "length", generator
        out, state = step_fn(params, state=state, tokens=torch.full(
            (1, 1), tok, dtype=torch.int64, device=device))
        logits = head(out) if use_head else out


def generate(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             sampling: SamplingConfig = SamplingConfig(),
             generator: Optional[torch.Generator] = None,
             max_seq: Optional[int] = None):
    """Prefill on ``batch`` then decode ``max_new_tokens`` greedily or
    sampled.  Returns (tokens (B, T), per-step entropy trace), T ≤
    max_new_tokens; EOS is tracked per sequence as in the reference.
    ``max_seq`` sizes the KV cache (default: the prompt, its vision
    prefix included, + max_new_tokens).  ``batch`` also carries
    ``enc_frames`` or ``vision_embeds`` where the model takes them."""
    tokens = batch["tokens"]
    device = tokens.device
    if generator is None:
        generator = _default_generator(device)
    if max_seq is None:
        max_seq = (tokens.shape[1] + max(cfg.n_patches, 0)
                   + sampling.max_new_tokens)
    prefill = jitted_prefill(cfg, max_seq)
    step_fn = jitted_decode_step(cfg)
    logits, state = prefill(params, batch=batch)
    b = tokens.shape[0]
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    outs = []
    entropies = []
    for _ in range(sampling.max_new_tokens):
        last = logits[:, -1]
        tok = sample_token(last, generator, sampling, cfg.vocab_size)
        if sampling.eos_id >= 0:
            tok = torch.where(done, torch.full_like(tok, sampling.eos_id),
                              tok)
        outs.append(tok)
        ent = token_entropy(last, cfg.vocab_size)
        live = ~done
        entropies.append(float(torch.where(live, ent, 0.0).sum()
                               / torch.clamp(live.sum(), min=1)))
        if sampling.eos_id >= 0:
            done = done | (tok == sampling.eos_id)
            if bool(done.all()):
                break
        logits, state = step_fn(params, state=state, tokens=tok[:, None])
    return torch.stack(outs, dim=1), entropies
