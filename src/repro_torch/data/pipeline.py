"""Synthetic token pipeline (port of ``repro.data.pipeline``).

Deterministic per-step draws: the numpy generator is seeded from
``(seed, step)``, so the tokens and labels of every step equal the
reference's exactly, and a restart at step N sees the batches the lost
run would have seen.  Batches are int32 tensors on the host; the caller
moves them to the device.

``extra`` inputs (encoder frames, vision embeddings) are f32 standard
normals from a ``torch.Generator`` seeded from ``(seed, step)``, so they
too are the same for every run of a step.  The reference draws them
with ``jax.random``, which torch cannot reproduce: only their shapes,
dtype and determinism match it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish synthetic text so losses are learnable (not pure noise)
    n_clusters: int = 64


def synth_batch(cfg: DataConfig, step: int,
                extra: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The full global batch of ``step``: successor sequences (next = cur
    + 1 mod V) with per-row offsets and 2% noise; ``extra`` maps each
    further input's name to its shape, drawn in the dict's order."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xC0FFEE]))
    b, s = cfg.global_batch, cfg.seq_len
    base = rng.integers(0, cfg.vocab_size, size=(b, 1))
    toks = (base + np.arange(s)[None, :]) % cfg.vocab_size
    noise = rng.random((b, s)) < 0.02
    toks = np.where(noise,
                    rng.integers(0, cfg.vocab_size, size=(b, s)), toks)
    toks = toks.astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    if extra:
        gen = torch.Generator().manual_seed(int(np.random.SeedSequence(
            [cfg.seed, step, 0xE7A]).generate_state(1, np.uint64)[0]))
        for name, shape in extra.items():
            batch[name] = torch.randn(tuple(shape), generator=gen,
                                      dtype=torch.float32)
    return batch


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  extra: Optional[Dict] = None) -> Iterator[Dict]:
    step = start_step
    while True:
        yield synth_batch(cfg, step, extra)
        step += 1
