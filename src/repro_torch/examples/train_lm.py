"""End to end: train a ~125M-parameter LM (port of
``examples/train_lm.py``).

The config is a scaled member of the qwen3 family (10 layers, d_model 640,
GQA 10/2 heads, 50k vocab ⇒ ~125M params).  The step is the compiled one
(``train.jitted_train_step``): on the card the first step is eager (the
warm-up), the second captures the whole step as a CUDA graph and every
later one replays it; on the CPU it stays eager.  The data pipeline and
checkpointing are the production ones (``data.synth_batch``,
``ft.checkpoint``: with ``--ckpt-dir``, ``{"params", "opt"}`` every 50
steps, parameters in the trainer's per-layer layout).

``--sparse-mlp`` makes every MLP down projection a BlockCSR driven by
``maple_spmm``, trained through the Maple kernels: on the card the
forward, its remat recompute and dB on the planned kernel (B4) and dA on
the block SDDMM (B2).  ``--partition D`` shards both sides of that plan
over D shards (``kernels.partition``): each shard runs B1 on its own
compact plan, the row-offset merge reassembles the rows, and dA is B2
per shard; with fewer cards than shards the shards run one after another
on the one card.  ``--partition 0`` takes the card count (1 on the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 12 \
          [--sparse-mlp] [--partition D] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, synth_batch
from repro_torch.examples import say
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models import lm
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               jitted_train_step, make_train_step)
from repro_torch.train.optimizer import tree_map

CKPT_EVERY = 50


def lm_125m(sparse_mlp: bool = False) -> ModelConfig:
    return ModelConfig(
        name="lm-125m-sparse" if sparse_mlp else "lm-125m", family="dense",
        n_layers=10, d_model=640, n_heads=10, n_kv_heads=2, head_dim=64,
        d_ff=2560, vocab_size=50_304, qk_norm=True,
        vocab_pad_multiple=64,
        # --sparse-mlp: train the Maple kernels end-to-end — every MLP down
        # projection is a BlockCSR driven by maple_spmm, with gradients
        # through the A^T pass + block SDDMM
        sparse_mlp=sparse_mlp, sparse_block=(64, 64), sparse_density=0.25,
    )


@dataclasses.dataclass
class TrainLmRun:
    """What a run leaves behind: the final parameters (per-layer layout)
    and optimizer state, the step function (on the card a
    ``train_step.CapturedTrainStep``), the sparse-MLP plan (None when
    dense) and its shard count, the data config, the printed lines, and
    one record per step (``loss``, ``grad_norm``, ``step_s``: wall
    seconds up to the step's loss on the host)."""
    cfg: ModelConfig
    params: Dict[str, Any]
    opt: Any
    step_fn: Callable
    mlp_plan: Any
    n_shards: int
    data: DataConfig
    device: torch.device
    lines: List[str]
    history: List[Dict[str, float]]


def run(cfg: ModelConfig, *, steps: int = 12, seq_len: int = 256,
        global_batch: int = 8, micro_batches: int = 2, lr: float = 3e-4,
        ckpt_dir: Optional[str] = None, partition: int = 0, device="cuda",
        params=None) -> TrainLmRun:
    """Train ``cfg`` for ``steps`` AdamW steps on ``synth_batch`` data,
    from weights drawn on the CPU from seed 0 (or ``params``, a stacked
    tree) and moved to ``device``."""
    dev = resolve_device(device)
    lines: List[str] = []
    say(lines, f"config: {cfg.name}, params ≈ {cfg.param_count():,}")
    if params is None:
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    # a copy: the steps update it in place, the caller's tree stays
    params = lm.unstack_layers(tree_map(lambda t: t.to(dev, copy=True),
                                        params))
    # one host-side symbolic pass per weight pattern: the compiled step
    # closes over the shared fwd+bwd plan (None for dense configs).
    # --partition lifts both sides to D shards: each owns an LPT share of
    # the weight's block-rows (kernels.partition), the backward
    # re-partitions on the transposed pattern.
    n_shards = partition or (torch.cuda.device_count() if dev.type == "cuda"
                             else 1)
    mlp_plan = lm.sparse_mlp_plan(params, n_shards=n_shards)
    if mlp_plan is not None:
        pc = mlp_plan.predicted_cycles()
        say(lines, f"sparse mlp plan: fwd {pc['fwd_plan']:.0f} + "
                   f"A^T {pc['at_plan']:.0f} block-MACs/lane predicted"
                   + (f" over {n_shards} devices" if n_shards > 1 else ""))
    ocfg = OptimizerConfig(peak_lr=lr, warmup_steps=5,
                           total_steps=max(steps, 100))
    opt = init_opt_state(ocfg, params)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    step_fn = jitted_train_step(make_train_step(cfg, ocfg, micro_batches,
                                                mlp_plan=mlp_plan), dev)

    tokens_per_step = seq_len * global_batch
    history: List[Dict[str, float]] = []
    for s in range(steps):
        batch = {k: v.to(dev) for k, v in synth_batch(dcfg, s).items()}
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        loss = float(m["loss"])                   # waits for the device
        dt = time.perf_counter() - t0
        rec = {"loss": loss, "grad_norm": float(m["grad_norm"]),
               "step_s": dt}
        history.append(rec)
        say(lines, f"step {s:4d} loss={loss:.4f} "
                   f"gnorm={rec['grad_norm']:.2f} "
                   f"({tokens_per_step / dt:,.0f} tok/s)")
        if ckpt_dir and (s + 1) % CKPT_EVERY == 0:
            ckpt.save(ckpt_dir, s + 1, {"params": params, "opt": opt})
    say(lines, "done")
    return TrainLmRun(cfg=cfg, params=params, opt=opt, step_fn=step_fn,
                      mlp_plan=mlp_plan, n_shards=n_shards, data=dcfg,
                      device=dev, lines=lines, history=history)


def main(argv=None) -> TrainLmRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--micro-batches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--sparse-mlp", action="store_true",
                    help="block-sparse trainable MLP down projections "
                         "(Maple kernels fwd+bwd)")
    ap.add_argument("--partition", type=int, default=0, metavar="D",
                    help="shard the sparse-MLP plans over D shards "
                         "(0 = one a card, 1 on the CPU; 1 = force "
                         "single-device); with fewer cards than D the "
                         "shards run one after another on one card")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(lm_125m(sparse_mlp=args.sparse_mlp), steps=args.steps,
               seq_len=args.seq_len, global_batch=args.global_batch,
               micro_batches=args.micro_batches, lr=args.lr,
               ckpt_dir=args.ckpt_dir, partition=args.partition,
               device=args.device)


if __name__ == "__main__":
    main()
