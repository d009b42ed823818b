"""Training launcher: random init from a seed, deterministic synthetic
data, AdamW steps with microbatch accumulation and straggler monitoring
(port of ``repro.launch.train``).  It trains every family: dense, MoE,
hybrid (RG-LRU + local attention), SSM, audio (whisper: encoder frames
drawn beside the tokens) and vlm (internvl: patch embeddings before
them), with the config's two-level remat and gradient accumulator.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --smoke --device cpu --steps 20 [--sparse-mlp] \
      [--ckpt-dir /tmp/ckpt --ckpt-every 10]
  (--arch: any config, e.g. recurrentgemma-9b, qwen3-moe-235b-a22b,
  granite-moe-3b-a800m, mamba2-2.7b, whisper-base, internvl2-1b)

A caller holding a :class:`ModelConfig` of its own (a depth cut, say)
runs it through :func:`run`, which ``main`` calls after parsing.

With ``--ckpt-dir`` the run resumes from the directory's latest
checkpoint (``ft.checkpoint``), saves ``{"params", "opt"}`` (parameters in
the trainer's per-layer layout) every ``--ckpt-every`` steps and at the
last, and keeps the newest 3, as the reference's launcher does; a resumed
run continues the same per-step data, so it ends where an uninterrupted
one does.  On the card the step is compiled once, as the reference's
``jax.jit``: the first step is eager (the warm-up), the second captures
the whole step as a CUDA graph and every later one replays it
(``train.jitted_train_step``); a resumed run hands over new parameter
tensors and so warms up and captures afresh.  On the CPU the step stays
eager.  ``--device`` (default ``cuda``) and ``--sparse-mlp`` (the
config's block-sparse MLP down-projection, trained through the Maple
kernels) are the port's own flags.  A caller that binds a mesh
(``distributed.sharding.use_mesh``) around :func:`run` trains an
``moe_impl="ep_a2a"`` config on the expert-parallel path.  Where the
mesh's entries name several cards (a ``(data=1, model=4)`` mesh of
``cuda:0`` to ``cuda:3``), the per-layer tree is placed with
``sharding.device_put_params`` (each ``model`` peer's expert slices on
its own card, everything else on the mesh's first card) before the
optimizer state is built on it, the step runs eagerly, and a checkpoint
saves and restores the placed tree in the whole tree's format.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, ModelConfig, get_config, \
    get_smoke_config
from repro_torch.data import DataConfig, synth_batch
from repro_torch.distributed.sharding import (active_mesh, device_put_params,
                                              mesh_devices)
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.straggler import StepTimer, StragglerMonitor
from repro_torch.models import lm
from repro_torch.train import (OptimizerConfig, init_opt_state,
                               jitted_train_step, make_train_step)


@dataclasses.dataclass
class TrainRun:
    """What a run leaves behind: the final parameters (per-layer layout)
    and optimizer state, the step function (on the card a
    ``train_step.CapturedTrainStep``), the optimizer config and microbatch count it
    was built with, data config and extra input shapes
    (``synth_batch(extra=…)``) it ran, and
    one record per step (``step``, ``loss``, ``grad_norm``, ``lr``,
    ``step_s`` — wall seconds up to the step's loss on the host)."""
    cfg: ModelConfig
    params: Dict[str, Any]
    opt: Any
    step_fn: Callable
    opt_cfg: OptimizerConfig
    micro_batches: Optional[int]
    data: DataConfig
    extra: Dict[str, tuple]
    device: torch.device
    history: List[Dict[str, float]]


def run(cfg: ModelConfig, *, steps: int = 20, seq_len: int = 64,
        global_batch: int = 4, micro_batches=None, lr: float = 3e-3,
        seed: int = 0, device="cuda", ckpt_dir=None,
        ckpt_every: int = 50) -> TrainRun:
    """Train ``cfg`` up to step ``steps`` with AdamW on ``synth_batch`` data
    of ``global_batch`` sequences of ``seq_len`` tokens (``micro_batches``:
    the config's own when None), parameters drawn from ``seed`` on
    ``device``; prints every fifth step's loss.  With ``ckpt_dir``: resume
    from its latest checkpoint, save every ``ckpt_every`` steps and at the
    last, keep the newest 3."""
    dev = resolve_device(device)
    ocfg = OptimizerConfig(peak_lr=lr, warmup_steps=5,
                           total_steps=max(steps, 10))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    extra = {}
    if cfg.n_enc_layers:
        extra["enc_frames"] = (global_batch, cfg.enc_seq, cfg.d_model)
    if cfg.n_patches:
        extra["vision_embeds"] = (global_batch, cfg.n_patches, cfg.d_model)

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.unstack_layers(lm.init_params(cfg, gen, device=dev))
    mesh = active_mesh()
    if mesh is not None and len(mesh_devices(mesh)) > 1:
        # each peer's expert slices on its card; the whole tree is dropped
        # before the optimizer state is allocated
        params = device_put_params(params, mesh)
    opt = init_opt_state(ocfg, params)
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        start, restored = ckpt.load(ckpt_dir, {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        del restored
        print(f"resumed from step {start}")
    # sparse-MLP configs: one host-side pass over the shared pattern (of
    # the restored parameters); every step reuses the forward +
    # transpose-side plan (None when dense)
    step_fn = jitted_train_step(
        make_train_step(cfg, ocfg, micro_batches,
                        mlp_plan=lm.sparse_mlp_plan(params)), dev)
    monitor = StragglerMonitor()
    host = "host0"
    history: List[Dict[str, float]] = []

    for step in range(start, steps):
        batch = {k: v.to(dev)
                 for k, v in synth_batch(dcfg, step, extra).items()}
        with StepTimer(monitor, host):
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])        # waits for the device
        rec = {"step": step, "loss": loss,
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]),
               "step_s": monitor.history[host][-1]}
        history.append(rec)
        flagged, _ = monitor.check()
        if flagged:
            print(f"[straggler] flagged: {flagged}")
        if step % 5 == 0 or step == steps - 1:
            print(f"step {step:5d} loss={rec['loss']:.4f} "
                  f"gnorm={rec['grad_norm']:.3f} lr={rec['lr']:.2e}",
                  flush=True)
        if ckpt_dir and ((step + 1) % ckpt_every == 0
                         or step == steps - 1):
            path = ckpt.save(ckpt_dir, step + 1,
                             {"params": params, "opt": opt})
            ckpt.garbage_collect(ckpt_dir, keep=3)
            print(f"checkpointed → {path}", flush=True)
    return TrainRun(cfg=cfg, params=params, opt=opt, step_fn=step_fn,
                    opt_cfg=ocfg, micro_batches=micro_batches, data=dcfg,
                    extra=extra, device=dev, history=history)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--sparse-mlp", action="store_true",
                    help="block-sparse MLP down-projection (Maple kernels)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--micro-batches", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.sparse_mlp:
        cfg = dataclasses.replace(cfg, sparse_mlp=True)
    return run(cfg, steps=args.steps, seq_len=args.seq_len,
               global_batch=args.global_batch,
               micro_batches=args.micro_batches, lr=args.lr, seed=args.seed,
               device=args.device, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
