#!/usr/bin/env python3
"""Time B4 under variants of ``csrc/maple_spmm.cu``, in one process.

Run from the repository root on a machine with one H100::

    python3 tools/spmm_walk/variants.py [variant ...]

Each variant is the source with some text replaced (``VARIANTS`` below);
all are built at once with ``nvcc`` into ``build/variants/`` and B4 is
timed on each at the MLP forward and Aᵀ dB plans (N = 256) and the logit
head (N = 1), f32 and bf16, after an L2 flush.  A variant that takes work
away (no reduction, no compute) gives wrong results: it only measures
what that work costs.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
os.chdir(ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.csr import bsr_transpose  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.maple_spmm import maple_spmm_planned  # noqa: E402
from repro_torch.kernels.schedule import plan_spmm_vjp  # noqa: E402

UNROLL = ("    for (int k0 = 0; k0 < geo.bk; k0 += 4) {\n      float a[TM][4];",
          "#pragma unroll 2\n    for (int k0 = 0; k0 < geo.bk; k0 += 4) {\n"
          "      float a[TM][4];")
VARIANTS = {
    "base": [],
    "noreduce": [("if (mine) reduce_partials<R, Q>(stash, base_i, v, t);",
                  ";")],
    "nocompute": [("      Tile::step(acc, ring + st * geo.stage_bytes, geo, "
                   "t);\n", "\n")],
    "unroll2": [UNROLL],
    "lb2": [("__launch_bounds__(kThreads, 1)",
             "__launch_bounds__(kThreads, 2)")],
    "lb3": [("__launch_bounds__(kThreads, 1)",
             "__launch_bounds__(kThreads, 3)")],
    "ring72": [("kRingBudget = 100 * 1024", "kRingBudget = 72 * 1024")],
    "stages4": [("if (g.stages > cap) g.stages = cap;",
                 "if (g.stages > kMaxStages) g.stages = kMaxStages;")],
    "tmprefetch": [("    const int lane = t - kConsumers;\n",
                    "    const int lane = t - kConsumers;\n"
                    "    if (lane == 0 && geo.b_mode == kBTensor)\n"
                    "      asm volatile(\"prefetch.tensormap [%0];\" :: \"l\"("
                    "reinterpret_cast<uint64_t>(&b_map)) : \"memory\");\n")],
}


def build(names):
    src = (_build.CSRC / "maple_spmm.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"{name}:\n{log[-3000:]}")
    return {n: out / f"{n}.so" for n in names}


def cases():
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
                yield (f"{shape['name'][:8]} {tag} N={n} "
                       f"{str(dtype)[6:]}",
                       (a.blocks, d["order"], d["step_col"], d["row_runs"],
                        d["row_run_ptr"], b3))


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(names)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    table = list(cases())
    res = {name: {} for name, _ in table}
    for variant, path in libs.items():
        lib = ctypes.CDLL(str(path))
        _build._declare("maple_spmm", lib)
        _build._LIBS["maple_spmm"] = lib
        for name, args in table:
            try:
                res[name][variant] = cs.time_ms(
                    lambda: maple_spmm_planned(*args), cs.REPS, flush)
            except RuntimeError as err:               # e.g. a ring too small
                res[name][variant] = str(err)[:80]
    for name, row in res.items():
        print(name, json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
