#!/usr/bin/env python3
"""Build the Hopper kernels, run their card tests and time B1 to B4, B7
and B8.

Run from the repository root on a machine with one H100::

    python3 tools/spmm_walk/shapes.py

Prints each kernel's registers and spills (``ptxas -v`` on
``maple_spmm.cu``, ``moe_gemm.cu``, ``maple_sddmm.cu`` and
``maple_spmspm.cu``), the card tests of the SpMM, SDDMM, element-walk
and MoE kernels, ``chip_smoke.py``'s SpMM, SDDMM, SpGEMM and MoE edge
cases, then one JSON line per B1 / B2 / B3 / B4 row of ``chip_smoke.py``'s
serving and training shapes, per B8 row of its MoE shapes and for B7 at
the cage12 clone (ms, plain, library, bound, B1 + merge).
"""
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
from repro_torch.kernels import _build  # noqa: E402


def ptxas(source: Path, names=("run_kernel", "compact_kernel",
                               "planned_kernel", "naive_kernel",
                               "moe_kernel", "moe_gemm_kernel",
                               "sddmm_kernel", "sddmm_bsr_kernel",
                               "spmspm_kernel", "block_attn_kernel",
                               "sddmm_csr_kernel", "spgemm_kernel",
                               "spgemm_db_kernel")) -> None:
    """Registers and spills of every kernel in ``source`` named like one
    of ``names``."""
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", os.devnull, str(source)],
                         capture_output=True, text=True)
    lines = (out.stdout + out.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(n in line
                                                      for n in names):
            fn = line.split("'")[1]
            used = next((x for x in lines[i + 1:i + 5] if "Used" in x), "")
            spill = next((x for x in lines[i + 1:i + 5] if "spill" in x), "")
            print(fn[:110], "|", used.split(":")[-1].strip(), "|",
                  spill.split(",", 1)[-1].strip(), flush=True)


def main() -> int:
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    for src in ("maple_spmm.cu", "moe_gemm.cu", "maple_sddmm.cu",
                "maple_spmspm.cu"):
        ptxas(_build.CSRC / src)
    _build.build_all()
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-x", "-m", "cuda",
         "tests/test_torch_kernels_cuda.py", "-p", "no:cacheprovider", "-k",
         "naive or compact or planned or maple_spmm or run_ or moe or "
         "sddmm or spmspm"],
        capture_output=True, text=True, env={**os.environ,
                                             "PYTHONPATH": "src"})
    print(tests.stdout[-2000:], tests.stderr[-2000:], flush=True)
    print("edge cases", cs.edge_cases() + cs.sddmm_edge_cases(), flush=True)
    print(json.dumps(cs.planned_edge_cases()), flush=True)
    print(json.dumps(cs.moe_kernels_edge()), flush=True)
    print(json.dumps(cs.spgemm_kernels_edge()), flush=True)
    spec = cs.card_spec(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    keys = ("name", "dtype", "shape", "G", "N", "bt", "ms", "plain_ms",
            "library_ms", "bound_ms", "compact_merge_ms", "runs")
    rows = cs.serving_shapes(spec, flush)[0] + \
        cs.training_shapes(spec, flush)[0] + cs.moe_rows(spec, flush) + \
        cs.spgemm(spec, flush, torch.cuda.get_device_name(0))[1]
    for row in rows:
        if row["name"] in ("maple_spmm_compact", "maple_spmm_planned",
                           "maple_spmm_naive", "moe_gemm", "maple_sddmm_bsr",
                           "maple_spmspm_ell"):
            print(json.dumps({k: row[k] for k in keys if k in row}),
                  flush=True)
    return 0 if tests.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
