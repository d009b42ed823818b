"""Serving launcher: batched generation against a randomly initialised
or restored model — prefill + decode with sampling (port of
``repro.launch.serve``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --smoke --batch 4 --prompt-len 16 --max-new 32 --temperature 0.8 \
      [--ckpt-dir /tmp/ckpt]

``--ckpt-dir`` loads ``{"params": …}`` from the directory's latest
training checkpoint (``launch.train --ckpt-dir``).  The trainer saves its
per-layer layout (``lm.unstack_layers``) and ``generate`` takes the
stacked one, so the parameters are loaded into the per-layer layout and
then stacked (``lm.stack_layers``).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models import lm
from repro_torch.serve import SamplingConfig, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=dev)
    if args.ckpt_dir:
        _, restored = ckpt.load(
            args.ckpt_dir, {"params": lm.unstack_layers(params, copy=False)})
        del params
        params = lm.stack_layers(restored.pop("params"))
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=dev)}
    if cfg.n_patches:
        batch["vision_embeds"] = torch.randn(
            (args.batch, cfg.n_patches, cfg.d_model), generator=gen,
            device=dev)
    if cfg.n_enc_layers:
        batch["enc_frames"] = torch.randn(
            (args.batch, cfg.enc_seq, cfg.d_model), generator=gen,
            device=dev)
    sampling = SamplingConfig(temperature=args.temperature,
                              top_k=args.top_k,
                              max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    tokens, entropies = generate(params, cfg, batch, sampling, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n = tokens.shape[0] * tokens.shape[1]
    print(f"generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({n / dt:.1f} tok/s incl. kernel build) on {dev}")
    print("first row:", tokens[0].tolist())
    print("entropy trace:", [f"{e:.2f}" for e in entropies[:8]])
    return tokens


if __name__ == "__main__":
    main()
