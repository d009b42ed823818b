#!/usr/bin/env python3
"""Time a ring kernel under variants of its source, in one process.

Run from the repository root on a machine with one H100::

    python3 tools/spmm_walk/variants.py [--kernel b4|b3|b8] [variant ...]

Each variant is the kernel's source with some text replaced (``VARIANTS``
below); all are built at once with ``nvcc`` into ``build/variants/`` and
the kernel is timed on each after an L2 flush, twice over: CUDA events
around the launch (``chip_smoke.time_ms``, what ``chip_smoke.py``
reports) and the kernel's own device time from ``torch.profiler``.  The
cases: B4 at the MLP forward and Aᵀ dB plans (N = 256) and the logit head
(N = 1); B3 at the MLP over 4 batches, N = 1, 112 and 128; B8 at
granite-moe-3b's four expert products; f32 and bf16.  A variant that takes
work away (no reduction, no compute) gives wrong results: it only
measures what that work costs.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
os.chdir(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

WALK = {
    "base": [],
    "noreduce": [("if (mine) reduce_partials<R, Q>(stash, base_i, v, t);",
                  ";")],
    "nocompute": [("      Tile::template step<kB3>(acc, ring + st * "
                   "geo.stage_bytes, geo, t,\n                               "
                   "cols);\n", "\n")],
    "lb2": [("__launch_bounds__(kThreads, 1)",
             "__launch_bounds__(kThreads, 2)")],
    "lb3": [("__launch_bounds__(kThreads, 1)",
             "__launch_bounds__(kThreads, 3)")],
    "ring72": [("kRingBudget = 100 * 1024", "kRingBudget = 72 * 1024")],
    "stages2": [("if (g.stages > cap) g.stages = cap;",
                 "if (g.stages > 2) g.stages = 2;")],
    "stages4": [("if (g.stages > cap) g.stages = cap;",
                 "if (g.stages > kMaxStages) g.stages = kMaxStages;")],
}
VARIANTS = {
    "b4": ("maple_spmm", {
        **WALK,
        "tmprefetch": [("    const int lane = t - kConsumers;\n",
                        "    const int lane = t - kConsumers;\n"
                        "    if (lane == 0 && geo.b_mode == kBTensor)\n"
                        "      asm volatile(\"prefetch.tensormap [%0];\" :: "
                        "\"l\"(reinterpret_cast<uint64_t>(&b_map)) : "
                        "\"memory\");\n")]}),
    "b3": ("maple_spmm", {
        **WALK,
        # g in the grid at every N: no folded batches
        "nofold": [("  if (p->kind != 0 && p->kind != 3) return cudaSuccess;",
                    "  return cudaSuccess;")]}),
    "b8": ("moe_gemm", {
        "base": [],
        "nocompute": [("    Tile::step(acc, ring + st * geo.stage_bytes, geo, "
                       "t, 0);\n", "\n")],
        # x's panel never loaded: what its (L2) reads cost
        "nox": [("          mbar_expect_tx(&full[st], geo.tx);\n"
                 "          tma_2d(stage, &x_map, d0, tok0, &full[st]);\n",
                 "          mbar_expect_tx(&full[st], geo.tx - geo.b_off);\n")],
        # y never written: what the epilogue's stores cost
        "noepi": [("  for (int idx = t; idx < rows * cpr; idx += kConsumers) {",
                   "  for (int idx = t; idx < 0; idx += kConsumers) {")],
        "ring72": [("kRingBudget = 48 * 1024", "kRingBudget = 72 * 1024")],
        "ring100": [("kRingBudget = 48 * 1024", "kRingBudget = 100 * 1024")],
        "lb1": [("__launch_bounds__(kThreads, 3)\nmoe_kernel",
                 "__launch_bounds__(kThreads)\nmoe_kernel")],
        "lb2": [("__launch_bounds__(kThreads, 3)\nmoe_kernel",
                 "__launch_bounds__(kThreads, 2)\nmoe_kernel")]}),
}
KERNEL_NAME = {"b4": "run_kernel", "b3": "run_kernel", "b8": "moe_kernel"}


def build(source, variants, names):
    src = (_build.CSRC / f"{source}.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in variants[name]:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        path = out / f"{source}-{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"{name}:\n{log[-3000:]}")
    return {n: out / f"{source}-{n}.so" for n in names}


def b4_cases():
    from repro_torch.core.csr import bsr_transpose
    from repro_torch.kernels.maple_spmm import maple_spmm_planned
    from repro_torch.kernels.schedule import plan_spmm_vjp
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    for dtype in (torch.float32, torch.bfloat16):
        for shape, n in ((cs.TRAIN_MLP, 256), (cs.HEAD, 1)):
            w = cs.sparse_weight(gen, shape, dtype)
            train = plan_spmm_vjp(w, n_lanes=shape.get("n_lanes", 8))
            mats = [("forward", w, train.fwd)]
            if shape is cs.TRAIN_MLP:
                mats.append(("dB", bsr_transpose(w), train.bwd))
            for tag, a, plan in mats:
                b3 = torch.randn((1, a.shape[1], n), device="cuda",
                                 generator=gen).to(dtype)
                d = plan.on_device(b3.device)
                args = (a.blocks, d["order"], d["step_col"], d["row_runs"],
                        d["row_run_ptr"], b3)
                yield (f"{shape['name'][:8]} {tag} N={n} {str(dtype)[6:]}",
                       lambda args=args: maple_spmm_planned(*args))


def b3_cases():
    from repro_torch.kernels.maple_spmm import maple_spmm_naive
    from repro_torch.kernels.ops import _meta_on
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    for dtype in (torch.float32, torch.bfloat16):
        w = cs.sparse_weight(gen, cs.MLP, dtype)
        meta = _meta_on(w, torch.device("cuda"))
        for n in (1, 112, 128):
            b3 = torch.randn((4, w.shape[1], n), device="cuda",
                             generator=gen).to(dtype)
            args = (w.blocks, meta["row_ptr"], meta["block_col"], b3)
            yield (f"mlp G=4 N={n} {str(dtype)[6:]}",
                   lambda args=args: maple_spmm_naive(*args, bn=128))


def b8_cases():
    from repro_torch.kernels.moe_gemm import moe_gemm
    for dtype in (torch.float32, torch.bfloat16):
        for name, cap, d, f in cs.MOE_SHAPES:
            rng = np.random.default_rng(cs.SEED + cap + d)
            x = torch.from_numpy(rng.standard_normal((cs.MOE_E * cap, d))
                                 .astype(np.float32)).cuda().to(dtype)
            w = torch.from_numpy(rng.standard_normal((cs.MOE_E, d, f))
                                 .astype(np.float32) / np.sqrt(d)
                                 ).cuda().to(dtype)
            eot = torch.arange(cs.MOE_E, dtype=torch.int32, device="cuda")
            yield (f"{name} {str(dtype)[6:]}",
                   lambda x=x, eot=eot, w=w, cap=cap:
                   moe_gemm(x, eot, w, bt=cap))


def device_ms(fn, flush, match, reps=10):
    """The mean device time of the kernels named like ``match`` over
    ``reps`` launches, each after an L2 flush (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if match in e.key]
    count = sum(e.count for e in evs)
    return sum(e.self_device_time_total for e in evs) / 1e3 / max(count, 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="b4", choices=sorted(VARIANTS))
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    source, table = VARIANTS[args.kernel]
    names = args.variants or list(table)
    libs = build(source, table, names)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    cases = list({"b4": b4_cases, "b3": b3_cases, "b8": b8_cases}
                 [args.kernel]())
    res = {name: {} for name, _ in cases}
    for variant, path in libs.items():
        lib = ctypes.CDLL(str(path))
        _build._declare(source, lib)
        _build._LIBS[source] = lib
        for name, fn in cases:
            try:
                res[name][variant] = [
                    round(cs.time_ms(fn, cs.REPS, flush), 5),
                    round(device_ms(fn, flush, KERNEL_NAME[args.kernel]), 5)]
            except RuntimeError as err:               # e.g. a ring too small
                res[name][variant] = str(err)[:80]
    print("variant: [events ms, profiler device ms]", flush=True)
    for name, row in res.items():
        print(name, json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
