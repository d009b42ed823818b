#!/usr/bin/env python3
"""Kernels of two trees timed in turns in one call: A, B, B, A.

Run from the repository root on a machine with one H100, after unpacking
the other tree into a git-ignored directory, for example::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/spmm_walk/compare_trees.py build/parent . [kernel ...]

``kernel`` names the rows to time (default: all of them):
``maple_spmm_compact`` and ``maple_spmm_planned`` (B1, B4: the serving
and training shapes), ``maple_spmm_naive`` (B3: the MLP at G 4, N 1, 112
and 128) and ``moe_gemm`` (B8: granite-moe-3b's four expert products).
Each turn runs in its own process from that tree (its ``chip_smoke.py``
and ``src/``, its own kernel build) and prints one JSON line per row,
tagged with the tree.  Also prints ``ptxas -v`` registers and spills of
each tree's ring kernels.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ALL = ("maple_spmm_compact", "maple_spmm_planned", "maple_spmm_naive",
       "moe_gemm")
TURN = r"""
import json, os, sys
root = os.path.abspath(sys.argv[1])
names = sys.argv[2].split(",")
sys.path[:0] = [os.path.join(root, "src"), root]
os.chdir(root)
import torch
import chip_smoke as cs
spec = cs.card_spec(torch.cuda.get_device_name(0))
flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
cs.MLP["N"] = (1, 112, 128)
rows = []
if {"maple_spmm_naive", "maple_spmm_compact", "maple_spmm_planned"} & set(names):
    rows += cs.serving_shapes(spec, flush)[0]
if {"maple_spmm_compact", "maple_spmm_planned"} & set(names):
    rows += cs.training_shapes(spec, flush)[0]
if "moe_gemm" in names:
    rows += cs.moe_rows(spec, flush)
for r in rows:
    if r["name"] in names:
        print(json.dumps({"tree": sys.argv[1], **{k: r[k] for k in (
            "name", "dtype", "shape", "G", "N", "bt", "ms",
            "compact_merge_ms", "library_ms", "bound_ms") if k in r}}),
            flush=True)
"""


def main() -> int:
    a, b = sys.argv[1:3]
    names = ",".join(sys.argv[3:] or ALL)
    here = Path(__file__).resolve().parent
    for tree in (a, b):
        for src in ("maple_spmm.cu", "moe_gemm.cu"):
            path = Path(tree) / "src" / "repro_torch" / "csrc" / src
            print("ptxas", tree, src, flush=True)
            subprocess.run([sys.executable, "-c",
                            "import sys; sys.path.insert(0, sys.argv[1]); "
                            "import shapes; from pathlib import Path; "
                            "shapes.ptxas(Path(sys.argv[2]))",
                            str(here), str(path.resolve())], check=True)
    for tree in (a, b, b, a):
        subprocess.run([sys.executable, "-c", TURN, tree, names],
                       check=False, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
