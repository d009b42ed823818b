#!/usr/bin/env python3
"""B1 and B4 of two trees timed in turns in one call: A, B, B, A.

Run from the repository root on a machine with one H100, after unpacking
the other tree into a git-ignored directory, for example::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/spmm_walk/compare_trees.py build/parent .

Each turn runs in its own process from that tree (its ``chip_smoke.py``
and ``src/``, its own kernel build) and prints one JSON line per B1 / B4
row of the serving and training shapes, tagged with the tree.  Also
prints ``ptxas -v`` registers and spills of each tree's B1 / B4 kernels.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path[:0] = [os.path.join(root, "src"), root]
os.chdir(root)
import torch
import chip_smoke as cs
spec = cs.card_spec(torch.cuda.get_device_name(0))
flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
rows = cs.serving_shapes(spec, flush)[0] + cs.training_shapes(spec, flush)[0]
for r in rows:
    if r["name"] in ("maple_spmm_compact", "maple_spmm_planned"):
        print(json.dumps({"tree": sys.argv[1], **{k: r[k] for k in (
            "name", "dtype", "shape", "N", "ms", "compact_merge_ms",
            "library_ms", "bound_ms") if k in r}}), flush=True)
"""


def main() -> int:
    a, b = sys.argv[1:3]
    here = Path(__file__).resolve().parent
    for tree in (a, b):
        src = Path(tree) / "src" / "repro_torch" / "csrc" / "maple_spmm.cu"
        print("ptxas", tree, flush=True)
        subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, sys.argv[1]); "
                        "import shapes; from pathlib import Path; "
                        "shapes.ptxas(Path(sys.argv[2]))",
                        str(here), str(src.resolve())], check=True)
    for tree in (a, b, b, a):
        subprocess.run([sys.executable, "-c", TURN, tree], check=False,
                       timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
