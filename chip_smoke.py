#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — requires CUDA, prints the card's name and power limit (as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them) and builds the CUDA kernels into ``build/kernels/``.
2. kernels — holds each Hopper kernel against its plain PyTorch version on
   the card: small edge cases (8×8 blocks, bn = 16, ragged N, empty rows,
   pad blocks, an all-empty matrix, a plan with idle lanes and split rows)
   and the serving shapes (the qwen3-4b MLP down-projection and the sparse
   logit head), in f32 and bf16, with the merge run twice for bit
   identity.  Prints kernel, plain, library (dense ``torch.matmul``) and
   bound times.
3. reference — the qwen3-4b smoke config on the card against the same
   weights on the CPU (the plain path the CPU tests hold against the JAX
   reference): logits within 1e-4, equal greedy tokens.
4. serve   — qwen3-4b at full width and depth with a block-sparse MLP and
   a block-sparse logit head, random weights from a seed, f32: ``generate``
   answers a batch of 4 prompts, ``complete_static`` answers the same 4
   requests one at a time through the ``SparseLogitHead``.  Launch counts
   are zeroed just before and read just after, and must equal one naive
   launch per layer per forward pass and one planned launch per head
   call.  Outside that counted run it times a prefill, a decode step and
   a head call, and profiles one decode step and one head call with
   ``torch.profiler`` (wall ms, summed kernel ms, the top kernels).
5. the ``{"kernels": [...]}`` summary, then the final ``{"ok": true, ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
SOURCE = "src/repro_torch/csrc/maple_spmm.cu"
REPLACES = {"maple_spmm_naive": "src/repro/kernels/maple_spmm.py:91",
            "maple_spmm_compact": "src/repro/kernels/maple_spmm.py:288"}
# the serving shapes of the kernels: the qwen3-4b MLP down-projection
# (d_ff -> d_model) as sparse_mlp builds it, over a batch of 4 sequences
# (G) at decode (N = 1 token) and prefill (N = 128 tokens); the sparse
# logit head (d_model -> padded vocab) as the serve benchmark builds it,
# one request at a time
MLP = dict(name="mlp_down 2560x9728 (64,64) d=0.25", d_out=2560, d_in=9728,
           block=(64, 64), density=0.25, G=4, N=(1, 128))
HEAD = dict(name="logit_head 153600x2560 (64,64) d=0.5 L=8", d_out=153_600,
            d_in=2560, block=(64, 64), density=0.5, n_lanes=8, G=1, N=(1, 4))
SERVE_ARCH = "qwen3-4b"
REPS = 20
# (HBM bytes/s, FP32 non-tensor FLOP/s) from NVIDIA's data sheets
CARD_SPECS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
              "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_spec(name: str):
    for key, spec in CARD_SPECS.items():
        if all(part in name for part in key.split()):
            return spec
    raise RuntimeError(f"no published rates for {name!r}; add them to "
                       f"CARD_SPECS")


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush (the weights of a layer loop are never L2-resident)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def check_close(got, want, dtype, what):
    """f32: only the order of summation differs; bf16: one rounding of
    the f32 sum at the end, at most one bf16 ulp (2^-8 relative) apart."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    limit = (1e-5 * scale + 1e-6) if dtype == torch.float32 else 1e-2 * scale
    if not err <= limit:
        raise AssertionError(f"{what}: max|kernel - plain| = {err} > {limit}")
    return err


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def bsr(rng, gm, gk, bm, bk, density, *, extra_pad=0, empty_rows=False,
        dtype=torch.float32):
    from repro_torch.core.csr import BlockCSR
    mask = rng.random((gm, gk)) < density
    if empty_rows:
        mask[::2] = False
    d = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    a = BlockCSR.from_dense(d, (bm, bk), n_blocks_max=int(mask.sum())
                            + 1 + extra_pad, device="cuda")
    return dataclasses.replace(a, blocks=a.blocks.to(dtype))


def run_naive_case(a, g, n, dtype, bn, rng):
    from repro_torch.kernels.maple_spmm import (maple_spmm_naive,
                                                maple_spmm_naive_plain)
    from repro_torch.kernels.ops import _meta_on
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).cuda().to(dtype)
    meta = _meta_on(a, b3.device)
    args = (a.blocks, meta["row_ptr"], meta["block_col"], b3)
    got = maple_spmm_naive(*args, bn=bn)
    torch.cuda.synchronize()
    want = maple_spmm_naive_plain(*args)
    return got, want, args, b3


def run_compact_case(a, plan, g, n, dtype, bn, rng):
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_compact_plain)
    from repro_torch.kernels.ops import _scatter_merge_f32
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).cuda().to(dtype)
    dev = plan.on_device(b3.device)
    n_slots = plan.n_lanes * plan.r_max
    args = (a.blocks, dev["order"], dev["step_col"], dev["runs"], b3)
    tiles = maple_spmm_compact(*args, n_slots=n_slots, bn=bn)
    torch.cuda.synchronize()
    want_tiles = maple_spmm_compact_plain(*args, n_slots=n_slots)
    live = torch.from_numpy(plan.slot_row.reshape(-1) >= 0).cuda()
    bm = plan.block_m
    view = lambda t: t.view(g, n_slots, bm, n)[:, live]
    merge = lambda t: _scatter_merge_f32(t.view(g, n_slots, bm, n),
                                         dev["merge"], gm=plan.n_block_rows)
    merged = [merge(tiles) for _ in range(2)]
    if not torch.equal(merged[0], merged[1]):
        raise AssertionError("slot merge is not bit-identical over two runs")
    return (view(tiles), view(want_tiles), merged[0], merge(want_tiles),
            args, n_slots, b3)


def edge_cases():
    from repro_torch.kernels.schedule import plan_spmm
    rng = np.random.default_rng(SEED)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for kw in (dict(), dict(empty_rows=True, extra_pad=3),
                   dict(density=0.0, extra_pad=2)):
            a = bsr(rng, 6, 5, 8, 8, kw.pop("density", 0.45), dtype=dtype,
                    **kw)
            for g, n in ((1, 1), (3, 21), (2, 40)):
                got, want, _, _ = run_naive_case(a, g, n, dtype, 16, rng)
                check_close(got, want, dtype, f"naive edge {kw} g{g} n{n}")
                cases += 1
            # split rows (chunk 1), idle lanes (8 lanes, rows whole)
            for lanes, chunk, whole in ((8, 1, False), (8, None, True),
                                        (3, None, False), (1, 2, False)):
                plan = plan_spmm(a, n_lanes=lanes, chunk=chunk,
                                 row_atomic=whole)
                tiles, want_tiles, merged, want_merged, *_ = \
                    run_compact_case(a, plan, 3, 21, dtype, 16, rng)
                check_close(tiles, want_tiles, dtype,
                            f"compact edge {kw} L{lanes}")
                check_close(merged, want_merged, dtype,
                            f"compact merge edge {kw} L{lanes}")
                cases += 1
    return cases


def measure(name, got, want, dtype, kernel, plain, library, nbytes, flops,
            spec, flush, reps, **shape):
    """Check the kernel against its plain version, then time the kernel,
    the plain version and the library call, and the bound."""
    err = check_close(got, want, dtype, f"{name} {shape}")
    ms = time_ms(kernel, reps, flush)
    plain_ms = time_ms(plain, max(3, reps // 4), flush)
    library_ms = time_ms(library, reps, flush)
    t_bytes, t_ops = nbytes / spec[0] * 1e3, flops / spec[1] * 1e3
    return {"name": name, "dtype": str(dtype).replace("torch.", ""),
            **shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sparse_weight(gen, shape, dtype):
    from repro_torch.models.layers import init_sparse_linear
    w = init_sparse_linear(gen, shape["d_in"], shape["d_out"],
                           block_shape=shape["block"],
                           block_density=shape["density"])
    return dataclasses.replace(w, blocks=w.blocks.to(dtype))


def spmm_cost(w, g, n, isz, out_bytes, meta_bytes):
    """(bytes, FLOPs) the function needs: live weight blocks, metadata, B
    and the output each moved once; 2 FLOPs per live weight element per
    output column."""
    bm, bk = w.block_shape
    live = w.nnzb * bm * bk
    return (live * isz + meta_bytes + g * w.shape[1] * n * isz + out_bytes,
            2 * live * n * g)


def serving_shapes(spec, flush):
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_compact_plain,
                                                maple_spmm_naive,
                                                maple_spmm_naive_plain)
    from repro_torch.kernels.ops import _scatter_merge_f32
    from repro_torch.kernels.schedule import plan_spmm
    rng = np.random.default_rng(SEED + 1)
    rows = []
    plan_s = None
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dtype).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        mlp = sparse_weight(gen, MLP, dtype)
        dense = mlp.to_dense()
        for n in MLP["N"]:
            g = MLP["G"]
            got, want, args, b3 = run_naive_case(mlp, g, n, dtype, 128, rng)
            nbytes, flops = spmm_cost(
                mlp, g, n, isz, out_bytes=g * mlp.shape[0] * n * isz,
                meta_bytes=4 * (mlp.n_block_rows + 1 + mlp.nnzb))
            rows.append(measure(
                "maple_spmm_naive", got, want, dtype,
                lambda: maple_spmm_naive(*args, bn=128),
                lambda: maple_spmm_naive_plain(*args),
                lambda: torch.matmul(dense, b3), nbytes, flops, spec, flush,
                REPS, G=g, N=n, shape=MLP["name"]))
        del dense, mlp
        head = sparse_weight(gen, HEAD, dtype)
        t0 = time.perf_counter()
        plan = plan_spmm(head, n_lanes=HEAD["n_lanes"])
        plan_s = time.perf_counter() - t0
        dense = head.to_dense()
        n_live = int((plan.slot_row >= 0).sum())
        bm = plan.block_m
        for n in HEAD["N"]:
            g = HEAD["G"]
            tiles, want_tiles, merged, want_merged, args, n_slots, b3 = \
                run_compact_case(head, plan, g, n, dtype, 128, rng)
            check_close(merged, want_merged, dtype, f"head merge n{n}")
            nbytes, flops = spmm_cost(
                head, g, n, isz, out_bytes=g * n_live * bm * n * 4,
                meta_bytes=4 * 2 * plan.order.size + 16 * plan.runs.shape[0])
            row = measure(
                "maple_spmm_compact", tiles, want_tiles, dtype,
                lambda: maple_spmm_compact(*args, n_slots=n_slots, bn=128),
                lambda: maple_spmm_compact_plain(*args, n_slots=n_slots),
                lambda: torch.matmul(dense, b3), nbytes, flops, spec, flush,
                REPS, G=g, N=n, shape=HEAD["name"])
            out = maple_spmm_compact(*args, n_slots=n_slots, bn=128)
            merge_ranks = plan.on_device(b3.device)["merge"]
            row["merge_ms"] = time_ms(
                lambda: _scatter_merge_f32(out.view(g, n_slots, bm, n),
                                           merge_ranks,
                                           gm=plan.n_block_rows),
                REPS, flush)
            rows.append(row)
        del dense, head
    return rows, plan_s


# --------------------------------------------------------------------------
# phase 3: the port on the card against the port's plain CPU path
# --------------------------------------------------------------------------

def small_reference():
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.csr import BlockCSR
    from repro_torch.models import lm
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import (SamplingConfig, SparseLogitHead,
                                   complete_static, generate)
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), sparse_mlp=True,
                              sparse_block=(8, 8))
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    move = lambda t: (dataclasses.replace(t, blocks=t.blocks.cuda(),
                                          device_meta={})
                      if isinstance(t, BlockCSR) else t.cuda())
    to_cuda = lambda tree: {k: to_cuda(v) if isinstance(v, dict) else move(v)
                            for k, v in tree.items()}
    gpu = to_cuda(cpu)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 9)))
    sampling = SamplingConfig(max_new_tokens=6)
    tok_cpu, _ = generate(cpu, cfg, {"tokens": prompts}, sampling)
    tok_gpu, _ = generate(gpu, cfg, {"tokens": prompts.cuda()}, sampling)
    lg_cpu, _ = lm.prefill(cpu, cfg, {"tokens": prompts})
    lg_gpu, _ = lm.prefill(gpu, cfg, {"tokens": prompts.cuda()})
    err = float((lg_gpu.cpu() - lg_cpu).abs().max())
    if not torch.allclose(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"card prefill logits differ from CPU: {err}")
    if not torch.equal(tok_cpu, tok_gpu.cpu()):
        raise AssertionError("card greedy tokens differ from CPU")
    w = init_sparse_linear(torch.Generator().manual_seed(SEED + 7),
                           cfg.d_model, cfg.vocab_padded, block_shape=(8, 8),
                           block_density=0.5)
    head_cpu = SparseLogitHead.build(w)
    head_gpu = SparseLogitHead.build(move(w))
    new_cpu = complete_static(cpu, cfg, prompts[0].numpy(), 5,
                              sampling=SamplingConfig(), head=head_cpu)[0]
    new_gpu = complete_static(gpu, cfg, prompts[0].numpy(), 5,
                              sampling=SamplingConfig(), head=head_gpu)[0]
    if new_cpu != new_gpu:
        raise AssertionError("card sparse-head greedy tokens differ from CPU")
    return {"phase": "reference", "config": "qwen3-4b smoke, sparse_mlp "
            "(8,8), sparse head (8,8) d=0.5", "prefill_max_abs_err": err,
            "greedy_tokens_equal": True}


# --------------------------------------------------------------------------
# phase 4: serve qwen3-4b at full width
# --------------------------------------------------------------------------

def serve(card):
    from repro_torch.configs import get_config
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_naive)
    from repro_torch.models import lm
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import (SamplingConfig, SparseLogitHead,
                                   complete_static, generate)
    cfg = dataclasses.replace(get_config(SERVE_ARCH), sparse_mlp=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_params(cfg, gen, device="cuda")
    head = SparseLogitHead.build(init_sparse_linear(
        gen, cfg.d_model, cfg.vocab_padded, block_shape=(64, 64),
        block_density=0.5))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompt_len = int(rng.integers(16, 129))
    prompts = rng.integers(0, cfg.vocab_size, (4, prompt_len))
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    new = 16
    sampling = SamplingConfig(max_new_tokens=new)

    maple_spmm_naive.launches = 0
    maple_spmm_compact.launches = 0
    t0 = time.perf_counter()
    tokens, _ = generate(params, cfg, batch, sampling)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [complete_static(params, cfg, p, new, sampling=SamplingConfig(),
                               head=head) for p in prompts]
    torch.cuda.synchronize()
    static_s = time.perf_counter() - t0
    launches = {"maple_spmm_naive": maple_spmm_naive.launches,
                "maple_spmm_compact": maple_spmm_compact.launches}
    # generate: one prefill + one decode step per new token; each request
    # of complete_static: one prefill + (new - 1) decode steps, each scored
    # by the head; every layer's MLP is one naive launch
    expect = {"maple_spmm_naive": cfg.n_layers * ((1 + new) + 4 * new),
              "maple_spmm_compact": 4 * new}

    if tokens.shape != (4, new) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(tokens.shape)} "
                             f"tokens outside the vocabulary")
    for toks, reason, _ in singles:
        if reason != "length" or len(toks) != new:
            raise AssertionError(f"complete_static ended with {reason!r} "
                                 f"after {len(toks)} tokens")
    if launches != expect:
        raise AssertionError(f"kernel launches on the path {launches}, "
                             f"expected {expect}")

    # checks and timings outside the counted run
    logits, state = lm.prefill(params, cfg, batch, max_seq=prompt_len + new)
    hidden, _ = lm.prefill(params, cfg, {"tokens": batch["tokens"][:1]},
                           return_hidden=True)
    if not (torch.isfinite(logits).all() and torch.isfinite(head(hidden))
            .all()):
        raise AssertionError("non-finite logits")
    alone, _ = lm.prefill(params, cfg, {"tokens": batch["tokens"][:1]})
    if not torch.allclose(alone, logits[:1], rtol=1e-3, atol=1e-3):
        raise AssertionError("batch-1 prefill logits differ from the batch's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm.prefill(params, cfg, batch, max_seq=prompt_len + new)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_tok = tokens[:, :1]
    t0 = time.perf_counter()
    for _ in range(4):
        _, state = lm.decode_step(params, cfg, state, step_tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / 4
    t0 = time.perf_counter()
    for _ in range(4):
        head(hidden)
    torch.cuda.synchronize()
    head_ms = (time.perf_counter() - t0) * 1e3 / 4
    profiles = {
        "decode_step": profile(lambda: lm.decode_step(params, cfg, state,
                                                      step_tok)),
        "sparse_head": profile(lambda: head(hidden))}
    return launches, {
        "phase": "serve", "config": "qwen3-4b sparse_mlp (64,64) d=0.25, "
        "sparse head (64,64) d=0.5 n_lanes=8, f32", "n_layers": cfg.n_layers,
        "depth_reduced": False, "batch": 4, "prompt_len": prompt_len,
        "new_tokens": new, "setup_s": setup_s, "generate_s": gen_s,
        "generate_tok_per_s": 4 * new / gen_s,
        "complete_static_s": static_s,
        "complete_static_tok_per_s": 4 * new / static_s,
        "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
        "sparse_head_ms": head_ms, "launches": launches, "card": card,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profiles": profiles}


def profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall ms, the device time
    summed over kernels, and the kernels that took the most of it."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA] or \
        [e for e in events if e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "launches": sum(e.count for e in kernels),
            "top": [{"kernel": e.key[:80], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:8]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    build_s = _build.build_all()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s})
    spec = card_spec(name)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")

    n_edge = edge_cases()
    emit({"phase": "kernels_edge", "cases": n_edge, "ok": True})
    rows, plan_s = serving_shapes(spec, flush)
    for row in rows:
        emit({"phase": "kernels", "card": smi, **row})
    emit({"phase": "head_plan", "plan_spmm_s": plan_s})

    emit(small_reference())
    launches, serve_line = serve(smi)
    emit(serve_line)

    summary = []
    for kname in ("maple_spmm_naive", "maple_spmm_compact"):
        mine = [r for r in rows if r["name"] == kname]
        top = next(r for r in mine if r["dtype"] == "float32"
                   and r["N"] == 1)
        summary.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": launches[kname],
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "G", "N", "shape")},
            "shapes": [{k: r[k] for k in ("dtype", "G", "N", "ms",
                                          "plain_ms", "library_ms",
                                          "bound_ms", "bound_by",
                                          "max_abs_err")} for r in mine]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
