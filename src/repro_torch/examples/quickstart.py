"""Quickstart: the three layers of this repo in a minute (port of
``examples/quickstart.py``).

1. Layer A — the paper's accelerator model: simulate Maple vs baseline
   Matraptor/Extensor on a Table-I clone (C = A×A).
2. Layer B — the Maple SpMM kernel: a block-CSR operand with no prebuilt
   plan (``maple_spmm`` plans it: the balanced schedule, whose layout runs
   on the planned kernel, B4, on the card) against the dense product.
3. Layer C — the production stack: three training steps of a reduced LM
   through the compiled step (``train.jitted_train_step``: on the card
   the whole step captured once as a CUDA graph and replayed) and a short
   greedy generation.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import analyze_spgemm, compare, sparsity
from repro_torch.core.csr import BlockCSR
from repro_torch.examples import say
from repro_torch.kernels import maple_spmm


def layer_a(device="cuda") -> dict:
    """The scircuit clone at scale 0.05 through the event model: its
    statistics and both families' comparisons."""
    lines = []
    say(lines, "== Layer A: Maple PE event model (paper §IV) ==")
    a = sparsity.generate(sparsity.TABLE_I["sc"], scale=0.05, device=device)
    stats = analyze_spgemm(a)
    say(lines, f"scircuit clone: nnz={stats.nnz_a:,} partial products="
               f"{stats.partial_products:,} nnz(C)={stats.nnz_c:,}")
    comparisons = {}
    for fam in ("matraptor", "extensor"):
        c = comparisons[fam] = compare(fam, stats)
        say(lines, f"  {fam:10s}: energy benefit "
                   f"{c.energy_benefit_pct:5.1f}% "
                   f"(on-chip {c.onchip_energy_benefit_pct:.1f}%), "
                   f"speedup {c.speedup_pct:5.1f}%, area {c.area_ratio:.1f}×")
    return {"lines": lines, "stats": stats, "compare": comparisons}


def layer_b(device="cuda") -> dict:
    """A 256 × 256 block-CSR operand of (64, 64) blocks, 40 % of them
    kept, times a dense (256, 128) B: the product (``out``, on
    ``device``), the blocks moved and max|err| against numpy's dense
    product."""
    dev = resolve_device(device)
    lines = []
    say(lines, "\n== Layer B: Maple SpMM CUDA kernel (BSR × dense) ==")
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((256, 256)).astype(np.float32)
    mask = rng.random((4, 4)) < 0.4          # 40% non-zero blocks
    for i in range(4):
        for j in range(4):
            if not mask[i, j]:
                dense[i*64:(i+1)*64, j*64:(j+1)*64] = 0
    a = BlockCSR.from_dense(dense, (64, 64), device=dev)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    out = maple_spmm(a, torch.from_numpy(b).to(dev))
    err = float((out.cpu() - torch.from_numpy(dense @ b)).abs().max())
    blocks = int(mask.sum())
    say(lines, f"  {blocks}/16 blocks moved (zero blocks skipped via "
               f"CSR metadata), max|err| vs dense = {err:.2e}")
    return {"lines": lines, "blocks": blocks, "err": err, "out": out}


def layer_c(device="cuda", params=None) -> dict:
    """qwen3-4b's smoke config (weights from seed 0, or ``params``):
    three AdamW steps of 4 × 32 tokens in 2 microbatches, then 8 greedy
    tokens after a prompt of eight 1s.  Returns the losses and tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import lm
    from repro_torch.serve import SamplingConfig, generate
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   jitted_train_step, make_train_step)
    from repro_torch.train.optimizer import tree_map

    dev = resolve_device(device)
    lines = []
    say(lines, "\n== Layer C: production stack (reduced qwen3-4b) ==")
    cfg = get_smoke_config("qwen3-4b")
    if params is None:
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    # a copy: the steps update it in place, the caller's tree stays
    params = lm.unstack_layers(tree_map(lambda t: t.to(dev, copy=True),
                                        params))
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10)
    opt = init_opt_state(ocfg, params)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    step = jitted_train_step(make_train_step(cfg, ocfg, micro_batches=2),
                             dev)
    losses = []
    for s in range(3):
        batch = {k: v.to(dev) for k, v in synth_batch(dcfg, s).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        say(lines, f"  step {s}: loss={losses[-1]:.3f}")
    with torch.no_grad():
        toks, _ = generate(lm.stack_layers(params), cfg,
                           {"tokens": torch.ones((1, 8), dtype=torch.int64,
                                                 device=dev)},
                           SamplingConfig(max_new_tokens=8))
    tokens = toks[0].tolist()
    say(lines, f"  greedy generation: {tokens}")
    return {"lines": lines, "losses": losses, "tokens": tokens,
            "step_fn": step}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return {"layer_a": layer_a(args.device), "layer_b": layer_b(args.device),
            "layer_c": layer_c(args.device)}


if __name__ == "__main__":
    main()
