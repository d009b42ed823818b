#!/usr/bin/env python3
"""Kernels of two or more trees timed in turns in one call: A, B, B, A
(or A, B, C, C, B, A).

Run from the repository root on a machine with one H100, after unpacking
the other trees into git-ignored directories, for example::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/spmm_walk/compare_trees.py build/parent . [kernel ...]

The leading arguments that are directories are the trees.

``kernel`` names the rows to time (default: all of them):
``maple_spmm_compact`` and ``maple_spmm_planned`` (B1, B4: the serving
and training shapes), ``maple_spmm_naive`` (B3: the MLP at G 4, N 1, 112
and 128), ``moe_gemm`` (B8: granite-moe-3b's four expert products),
``moe_backward`` (``chip_smoke.moe_train_rows``: B8's forward, its dx and
``moe_dw_kernel`` at granite-moe-3b's training shapes, gate and down, f32
and bf16, each row's ``kernel`` and ``shape`` saying which),
``maple_sddmm_bsr`` (B2: dA of the MLP at N 256 and of the head at N 4,
as ``chip_smoke.py``'s training shapes build them) and
``maple_spmspm_ell`` (B7: the cage12 clone's ELL times a dense (n, 64)
B), ``block_attention`` (B9 at recurrentgemma-9b's local attention, f32
and bf16) and ``maple_spgemm_numeric``, ``maple_sddmm_csr`` and
``maple_spgemm_db`` (B5, B6 and dB of C = A×A on the cage12 and
poisson3Da clones).  Each
turn runs in its own process from that tree (its ``chip_smoke.py`` and
``src/``, its own kernel build) and prints one JSON line per row, tagged
with the tree.  B2, B5, B6, dB, B7 and B9 are timed alone (events, after
an L2 flush), the other rows with their plain, library and bound times.
Also prints ``ptxas -v`` registers and spills of each tree's kernels.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ALL = ("maple_spmm_compact", "maple_spmm_planned", "maple_spmm_naive",
       "moe_gemm", "moe_backward", "maple_sddmm_bsr", "maple_spmspm_ell",
       "block_attention", "maple_spgemm_numeric", "maple_sddmm_csr",
       "maple_spgemm_db")
SOURCES = ("maple_spmm.cu", "moe_gemm.cu", "maple_sddmm.cu",
           "maple_spmspm.cu", "maple_spgemm.cu", "block_attn.cu")
TURN = r"""
import json, os, sys
import numpy as np
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
if "moe_backward" in names:
    rows += [dict(r, kernel=r["name"], name="moe_backward")
             for r in cs.moe_train_rows(spec, flush)]
if "maple_sddmm_bsr" in names:
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr
    rng = np.random.default_rng(cs.SEED + 3)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
        for shape in (cs.TRAIN_MLP, cs.TRAIN_HEAD):
            w = cs.sparse_weight(gen, shape, dtype)
            g, n = shape["G"], shape["N"][0]
            args = cs.run_sddmm_case(w, g, n, dtype, 128, rng)[2]
            fn = lambda: maple_sddmm_bsr(*args, bm=64, bk=64)
            rows.append({"name": "maple_sddmm_bsr", "shape": shape["name"],
                         "dtype": str(dtype)[6:], "G": g, "N": n,
                         "ms": cs.time_ms(fn, cs.REPS, flush)})
            del w, args
if "maple_spmspm_ell" in names:
    from repro_torch.core import sparsity
    from repro_torch.core.formats import csr_to_ell
    from repro_torch.kernels.maple_spmspm import maple_spmspm_ell
    a = sparsity.generate(sparsity.TABLE_I[cs.CAGE12], scale=cs.CAGE12_SCALE,
                          seed=cs.SEED, device="cuda")
    values, col_ids = csr_to_ell(a)
    dense_b = torch.from_numpy(np.random.default_rng(cs.SEED + 9)
                               .standard_normal((a.shape[0], cs.SPMSPM_N))
                               .astype(np.float32)).cuda()
    fn = lambda: maple_spmspm_ell(values, col_ids, dense_b)
    rows.append({"name": "maple_spmspm_ell", "dtype": "float32",
                 "shape": f"{cs.CAGE12} ELL {tuple(values.shape)} x "
                 f"({a.shape[0]}, {cs.SPMSPM_N})",
                 "ms": cs.time_ms(fn, cs.REPS, flush)})
if "block_attention" in names:
    from repro_torch.kernels import local_window_kv_map
    from repro_torch.kernels.block_attn import block_attention
    a = cs.ATTN
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q = torch.randn((a["B"], a["S"], a["H"], a["hd"]), generator=gen,
                    device="cuda")
    k, v = [torch.randn((a["B"], a["S"], 1, a["hd"]), generator=gen,
                        device="cuda").expand(q.shape).contiguous()
            for _ in range(2)]
    kv_map = torch.from_numpy(local_window_kv_map(
        a["S"], a["window"], a["bq"], a["bk"])).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        args = [x.to(dtype) for x in (q, k, v)] + [kv_map]
        fn = lambda: block_attention(*args, bq=a["bq"], bk=a["bk"],
                                     window=a["window"])
        rows.append({"name": "block_attention", "dtype": str(dtype)[6:],
                     "shape": "recurrentgemma-9b local attention",
                     "ms": cs.time_ms(fn, cs.REPS, flush)})
        del args
    del q, k, v
    torch.cuda.empty_cache()
spgemm_names = ("maple_spgemm_numeric", "maple_sddmm_csr", "maple_spgemm_db")
if set(spgemm_names) & set(names):
    from repro_torch.core import sparsity
    from repro_torch.kernels import plan_spgemm
    from repro_torch.kernels.maple_sddmm import maple_sddmm_csr
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_numeric)
    for tag in ("cg", "p3"):         # cage12, poisson3Da
        a = sparsity.generate(sparsity.TABLE_I[tag], scale=1.0, seed=cs.SEED,
                              device="cuda")
        plan = plan_spgemm(a, a)
        dc = torch.from_numpy(np.random.default_rng(cs.SEED + 10)
                              .standard_normal(plan.nnz_c)
                              .astype(np.float32)).cuda()
        for name, fn in zip(spgemm_names, (
                lambda: maple_spgemm_numeric(a.value, a.value, plan,
                                             cap=plan.nnz_c),
                lambda: maple_sddmm_csr(dc, a.value, plan, n_slots=a.nnz),
                lambda: maple_spgemm_db(dc, a.value, plan, n_slots=a.nnz))):
            rows.append({"name": name, "dtype": "float32",
                         "shape": f"{tag} C=A×A", "ms": cs.time_ms(
                             fn, cs.REPS, flush)})
        del a, plan, dc
for r in rows:
    if r["name"] in names:
        print(json.dumps({"tree": sys.argv[1], **{k: r[k] for k in (
            "name", "kernel", "dtype", "shape", "G", "N", "bt", "ms",
            "compact_merge_ms", "plain_ms", "library_ms", "bound_ms")
            if k in r}}),
            flush=True)
"""


def main() -> int:
    trees = [arg for arg in sys.argv[1:] if Path(arg).is_dir()]
    names = ",".join(arg for arg in sys.argv[1:] if arg not in trees) \
        or ",".join(ALL)
    here = Path(__file__).resolve().parent
    for tree in trees:
        for src in SOURCES:
            path = Path(tree) / "src" / "repro_torch" / "csrc" / src
            print("ptxas", tree, src, flush=True)
            subprocess.run([sys.executable, "-c",
                            "import sys; sys.path.insert(0, sys.argv[1]); "
                            "import shapes; from pathlib import Path; "
                            "shapes.ptxas(Path(sys.argv[2]))",
                            str(here), str(path.resolve())], check=True)
    # every turn plans the same cage12 clone (sparsity.generate seeds
    # with the string hash of its name)
    env = {**os.environ, "PYTHONHASHSEED": "0"}
    for tree in trees + trees[::-1]:
        subprocess.run([sys.executable, "-c", TURN, tree, names],
                       check=False, timeout=900, env=env)
    return 0


if __name__ == "__main__":
    sys.exit(main())
