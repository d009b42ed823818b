#!/usr/bin/env python3
"""Time a kernel under variants of its source, in one process.

Run from the repository root on a machine with one H100::

    python3 tools/spmm_walk/variants.py \
        [--kernel b4|b3|b8|dx|dw|b2|b7|b9|b6|b5|db] [variant ...]

Each variant is the kernel's source (or ``hopper.cuh``) with some text
replaced (``VARIANTS`` below); all are built at once with ``nvcc`` into
``build/variants/`` and
the kernel is timed on each after an L2 flush, twice over: CUDA events
around the launch (``chip_smoke.time_ms``, what ``chip_smoke.py``
reports) and the kernel's own device time from ``torch.profiler``.  The
cases: B4 at the MLP forward and Aᵀ dB plans (N = 256) and the logit head
(N = 1); B3 at the MLP over 4 batches, N = 1, 112 and 128; B8 at
granite-moe-3b's four expert products; B8's dx (``dx``) and
``moe_dw_kernel`` (``dw``) at its training shapes (capacity 56, gate and
down); B2 (dA) at the MLP (N = 256) and
the head (N = 4); f32 and bf16; B7 at the cage12 clone's ELL times a
dense (n, 64) B, f32; B9 at recurrentgemma-9b's local attention, f32
and bf16; B5 (the SpGEMM's numeric phase), B6 (its dA) and dB on C = A×A
over the cage12 and poisson3Da clones, f32.
A variant that takes work away (no reduction, no compute) gives wrong
results: it only measures what that work costs.  For B9 each variant's
output is also held against the plain version, as ``chip_smoke.py`` holds
it (``check_close``, and ``check_rows`` in bf16), and the two ratios to
their limits are printed: the planted faults ``skipchunk`` and ``wide1``
show what each check catches; B5's and dB's likewise (``check_close``).
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

# B5's and dB's source texts that the variants replace
B5_POS = """            at[d][k] = __ldg(pos_row + pp[d] + u);
            pr[d][k] = __fmul_rn(a[d], to_f32(__ldg(b_val + b0[d] + u)));"""
B5_NOPOS = """            at[d][k] = u;
            pr[d][k] = a[d] * u;"""
B5_TAIL = """          const int p = __ldg(pos_row + pp[d] + u);
          psb[p] = __fadd_rn(psb[p],
                             __fmul_rn(a[d], to_f32(__ldg(b_val + b0[d] + u))));"""
B5_NOTAIL = """          psb[u] += a[d];"""
DB_GATHER = ("g[d][q] = at[d][q] >= 0 ? to_f32(__ldg(dc + at[d][q])) "
             ": 0.0f;")
DB_NOGATHER = "g[d][q] = (float)at[d][q];"
DB_META = "my_a = to_f32(a_val[__ldg(t_perm + f0 + t0 + j)]);"
DB_NOMETA = "my_a = 1.0f;"
B5_PREFETCH = "  prefetch_l2<G>(pos_row, n_p, j);\n"
B5_LB = "__launch_bounds__(256)\nspgemm_kernel"
B5_ENTRY = "  if (rows < 1 || lc < 1) return (int)cudaErrorInvalidValue;\n"
B5_NARROW, B5_WIDE = "X(0, 8, 2, 3)", "X(1, 32, 4, 1)"   # MAPLE_SPGEMM_ROUTES
DB_LB = "__launch_bounds__(256)\nspgemm_db_kernel"

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
DX_STEP = ("    Tile::step(acc, ring + st * geo.stage_bytes, geo, t, 0);\n",
           "\n")
DW_LOADS = ("""                mbar_expect_tx(&full[st], geo.tx);
                tma_3d(stage, &x_map, d0, r0, tile, &full[st]);
                tma_3d(gst, &dy_map, f0, r0, tile, &full[st]);
                if constexpr (sizeof(T) == 2)
                  tma_3d(gst + geo.kr * 128, &dy_map, f0 + 64, r0, tile,
                         &full[st]);
""", "")
DW_STEP = ("      Tile::step(acc, smem + st * geo.stage_bytes, geo, live, "
           "t);\n", "\n")
DW_EPI = [("    Tile::put(acc, out, t);\n", "\n"),
          ("        Tile::store(&dw_map, out, geo, e, d0, f0);\n", "\n")]
DW_SYNC = [("    consumer_sync();                         // the buffer is "
            "free\n", "\n"),
           ("      consumer_sync();                       // the tile is "
            "written\n", "\n")]
DW_FENCE = ("    if (geo.tma) {\n      fence_async_smem();",
            "    if (geo.tma) {\n")
VARIANTS.update({
    "dx": ("moe_gemm", {
        "base": [],
        "nocompute": [DX_STEP],
        # w and dy by the producer's copies into the same swizzled layout
        "producer": [("           al(w);\n", "           al(w) && !trans;\n")],
        "lb2": [("__launch_bounds__(kThreads, 3)\nmoe_kernel",
                 "__launch_bounds__(kThreads, 2)\nmoe_kernel")],
        "lb4": [("__launch_bounds__(kThreads, 3)\nmoe_kernel",
                 "__launch_bounds__(kThreads, 4)\nmoe_kernel")],
        # the k-major tile's quads one or four a loop turn (two: base)
        "unroll1": [("                         128, 2>;",
                     "                         128, 1>;")],
        "unroll4": [("                         128, 2>;",
                     "                         128, 4>;")]}),
    "dw": ("moe_gemm", {
        "base": [],
        # the loads and stores kept, the products taken away
        "nocompute": [DW_STEP],
        # dW never stored: what the TMA stores cost
        "nostore": [("        Tile::store(&dw_map, out, geo, e, d0, f0);\n",
                     "\n")],
        # x's panel never loaded: what its (L2) reads cost
        "nox": [("                mbar_expect_tx(&full[st], geo.tx);\n"
                 "                tma_3d(stage, &x_map, d0, r0, tile, "
                 "&full[st]);\n",
                 "                mbar_expect_tx(&full[st], geo.tx - "
                 "geo.b_off);\n")],
        # the producer's and the threads' own copies at every shape
        "producer": [("  g->tma = T > 0 &&", "  g->tma = false &&")],
        # dy's panel never loaded: what its (L2) reads cost
        "nody": [("                tma_3d(gst, &dy_map, f0, r0, tile, "
                  "&full[st]);\n                if constexpr (sizeof(T) "
                  "== 2)\n                  tma_3d(gst + geo.kr * 128, "
                  "&dy_map, f0 + 64, r0, tile,\n                         "
                  "&full[st]);\n", ""),
                 ("mbar_expect_tx(&full[st], geo.tx);",
                  "mbar_expect_tx(&full[st], geo.b_off);")],
        # bf16: one out buffer, then as many stages as fit
        "outs1": [("max(1, min(kDwMaxOut, g->out_bufs))",
                   "max(1, min(1, g->out_bufs))")],
        # each CTA a run of consecutive tiles, not every gridDim-th
        "chunked": [("for (int item = blockIdx.x; item < geo.items; "
                     "item += gridDim.x) {",
                     "for (int item = (int)((int64_t)blockIdx.x * geo.items "
                     "/ gridDim.x); item < (int)((int64_t)(blockIdx.x + 1) "
                     "* geo.items / gridDim.x); ++item) {")],
        # bf16: one CTA an SM, 2 out buffers and 8 stages
        "stages8": [("kDwBudgetBf16 = 112 * 1024;",
                     "kDwBudgetBf16 = 224 * 1024;"),
                    ("constexpr int kDwMaxStages = 4;",
                     "constexpr int kDwMaxStages = 8;"),
                    ("sizeof(T) == 2 ? 2 : 3)", "sizeof(T) == 2 ? 1 : 3)")],
        # the tile stored by the consumer threads, 16 bytes each, where
        # the TMA could store it
        "threadstore": [("    if (geo.tma) {\n      fence_async_smem();",
                         "    if (false) {\n      fence_async_smem();")],
        # the stages never loaded (their barriers complete on the
        # producer's arrivals), the tiles never put or stored, or both, or
        # also no products: what the loads, the epilogue and the loop
        # skeleton cost; the kernel ending after its set-up (its fixed cost)
        "noload": [DW_LOADS],
        "noepi": DW_EPI,
        "skeleton": [DW_LOADS] + DW_EPI,
        "skelnocomp": [DW_LOADS, DW_STEP] + DW_EPI,
        "skelnosync": [DW_LOADS, DW_STEP] + DW_EPI + DW_SYNC,
        "skelnofence": [DW_LOADS, DW_STEP] + DW_EPI + [DW_FENCE],
        "empty": [("  if (t >= kConsumers) {\n    // ---- producer warp: each",
                   "  if (geo.items >= 0) return;\n  if (t >= kConsumers) {\n"
                   "    // ---- producer warp: each")],
        # bf16: 3 CTAs an SM, stages of 32 token rows
        "bf16x3": [("kDwBudgetBf16 = 112 * 1024;", "kDwBudgetBf16 = 72 * 1024;"),
                   ("cap = dtype ? 64 : 24;", "cap = dtype ? 32 : 24;"),
                   ("sizeof(T) == 2 ? 2 : 3)", "sizeof(T) == 2 ? 3 : 3)")],
        # f32 stages of 16 or 32 token rows
        "f32rows16": [("cap = dtype ? 64 : 24;", "cap = dtype ? 64 : 16;")],
        "f32rows32": [("cap = dtype ? 64 : 24;", "cap = dtype ? 64 : 32;")]}),
    "b2": ("maple_sddmm", {
        "base": [],
        "nocompute": [("        Tile::step(acc, a, stage, geo, "
                       "chunk_live(geo, c), t);\n", "\n")],
        # the stages never loaded (their bytes are garbage): what the
        # products cost alone
        "noload": [(
            "        if (geo.tma && lane == 0) mbar_expect_tx(&full[st], "
            "geo.tx_stage);\n        load_chunk<T>(stage, &b_map, b, geo.K, "
            "col * geo.bk, geo.bk, c, geo,\n                      &full[st], "
            "lane);\n        if (!geo.panels)                     // dC "
            "streamed beside B\n          load_chunk<T>(stage + geo.b_bytes, "
            "&dc_map, dc, geo.M,\n                        row * geo.bm, "
            "geo.bm, c, geo, &full[st], lane);\n", "")],
        # the f32 64 × 64 tile with its geometry read at run time
        "generic64": [("kWgmmaKind : kFixedKind;",
                       "kWgmmaKind : ffma_tile(bm, bk);")],
        # whole runs of the same length (the last CTA short), as many
        # CTAs as that takes, not an even share over every resident CTA
        "whole": [("    if (grid < resident) grid = resident;",
                   "    const int64_t c0 = (n + resident - 1) / resident;\n"
                   "    const int64_t c = c0 < kMaxChunk ? c0 : kMaxChunk;\n"
                   "    grid = (n + c - 1) / c;")],
        # tiles never stored: what the bulk stores cost
        "nostore": [("      bulk_store(out + (int64_t)(s0 + si) * geo.bm * "
                     "geo.bk, o,\n                 geo.out_bytes);\n",
                     "\n")],
        # the dC panel reloaded at every slot, as before this design
        "noreuse": [("      if (geo.panels && row != cur) {",
                     "      if (geo.panels) {"),
                    ("        if (row != cur) {", "        if (true) {")],
        "chunk8": [("constexpr int kMaxChunk = 16;",
                    "constexpr int kMaxChunk = 8;")],
        "chunk32": [("constexpr int kMaxChunk = 16;",
                     "constexpr int kMaxChunk = 32;")],
        # the FFMA tile's swizzle keys computed row by row
        "keyed": [("    if (!swz || (ty_n % 8 == 0 && tx_n % 8 == 0))",
                   "    if (false)")],
        # the layout aimed at fewer CTAs an SM
        "ctas3": [("constexpr int kMaxCtas = 4;",
                   "constexpr int kMaxCtas = 3;")],
        "ctas2": [("constexpr int kMaxCtas = 4;",
                   "constexpr int kMaxCtas = 2;")],
        "unroll2": [("using Tile = FfmaTileK<T, TM, TN, BM, BK, PITCH>;",
                     "using Tile = FfmaTileK<T, TM, TN, BM, BK, PITCH, 2>;")]}),
    "b7": ("maple_spmspm", {
        "base": [],
        # the loads kept, the products and sums taken away
        "nocompute": [("              acc[e] = __fadd_rn(acc[e], "
                       "__fmul_rn(a[u], x[u][e]));",
                       "              acc[e] = x[u][e];")],
        "batch8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
        "batch2": [("constexpr int kBatch = 4;", "constexpr int kBatch = 2;")],
        # B rows read past L1 (L2 only): what L1's hits are worth
        "cg": [("__ldg(", "__ldcg(")],
        "lb6": [("__launch_bounds__(kWarps * 32)",
                 "__launch_bounds__(kWarps * 32, 6)")],

        "warps4": [("constexpr int kWarps = 8;",
                    "constexpr int kWarps = 4;")]}),
})
B9_NOS = [("for (int b = 0; b < NB; ++b) {\n          const int",
           "for (int b = 0; b < 0; ++b) {\n          const int")]
B9_NOPV = [("for (int kq = 0; kq < KT; kq += 4) {",
            "for (int kq = 0; kq < 0; kq += 4) {"),
           ("for (int j = 0; j < 4; ++j) pv_atoms<NB>",
            "for (int j = 0; j < 0; ++j) pv_atoms<NB>")]
VARIANTS.update({
    "b9": ("block_attn", {
        "base": [],
        # both products taken away (f32 and bf16): loads, softmax, syncs
        "nocompute": B9_NOS + B9_NOPV,
        "nos": B9_NOS,
        "nopv": B9_NOPV,
        # the producer warpgroup down to 24 registers, the consumers 240
        "regs240": [("constexpr int kProducerRegs = 40;\nconstexpr int "
                     "kConsumerRegs = 232;", "constexpr int kProducerRegs = "
                     "24;\nconstexpr int kConsumerRegs = 240;")],
        # f32 P·V: one or all of a chunk's 4-key steps a loop turn
        "pvunroll1": [("#pragma unroll 2\n        for (int kq = 0; kq < KT; "
                       "kq += 4) {", "#pragma unroll 1\n        for (int kq "
                       "= 0; kq < KT; kq += 4) {")],
        "pvunroll8": [("#pragma unroll 2\n        for (int kq = 0; kq < KT; "
                       "kq += 4) {", "#pragma unroll\n        for (int kq "
                       "= 0; kq < KT; kq += 4) {")],
        # planted faults, to show what the checks catch: the second chunk
        # of each CTA's walk skipped, or the window one key wider
        "skipchunk": [("  int e = 0, c0 = 0;\n",
                       "  int e = 0, c0 = 0, n = 0;\n"),
                      ("      if (visible(g, lo, hi, k_lo, k_n)) return true;",
                       "      if (visible(g, lo, hi, k_lo, k_n) && ++cur.n "
                       "!= 2)\n        return true;")],
        "wide1": [("(g.window <= 0 || qpos - kpos < g.window);",
                   "(g.window <= 0 || qpos - kpos <= g.window);")],
        "stages2": [("  if (g.stages > kMaxStages) g.stages = kMaxStages;",
                     "  if (g.stages > 2) g.stages = 2;")],
        "stages3": [("  if (g.stages > kMaxStages) g.stages = kMaxStages;",
                     "  if (g.stages > 3) g.stages = 3;")],
        "stages4": [("  if (g.stages > kMaxStages) g.stages = kMaxStages;",
                     "  if (g.stages > 4) g.stages = 4;")],
        # the V chunks never loaded (their stages complete on the
        # producer's arrivals): what half the K / V stream costs
        "nov": [("        load_tile<T, NB>(smem + g.ring_off + st * "
                 "g.tile_bytes,\n", "        if (kv) mbar_arrive(&full[st]);"
                 "\n        else load_tile<T, NB>(smem + g.ring_off + st * "
                 "g.tile_bytes,\n")]}),
    "b6": ("maple_spgemm", {
        "base": [],
        # the pos and B loads kept, the dC gathers and products taken away
        "nocompute": [("bv[d][0] * to_f32(__ldg(dc_row + at[d][0]))",
                       "bv[d][0] + at[d][0]"),
                      ("acc = fmaf(bv[d][k], to_f32(__ldg(dc_row + "
                       "at[d][k])), acc);",
                       "acc += bv[d][k] + at[d][k];")],
        "depth1": [("constexpr int kCsrDepth = 2;",
                    "constexpr int kCsrDepth = 1;")],
        "depth4": [("constexpr int kCsrDepth = 2;",
                    "constexpr int kCsrDepth = 4;")],
        # 4 lanes a row and 6 steps a slot
        "group4": [("constexpr int kCsrGroup = 8;",
                    "constexpr int kCsrGroup = 4;"),
                   ("constexpr int kCsrSteps = 3;",
                    "constexpr int kCsrSteps = 6;")],
        "steps2": [("constexpr int kCsrSteps = 3;",
                    "constexpr int kCsrSteps = 2;")],
        "steps4": [("constexpr int kCsrSteps = 3;",
                    "constexpr int kCsrSteps = 4;")],
        # 32 registers a thread: 8 CTAs an SM
        "lb8": [("__launch_bounds__(256)\nsddmm_csr_kernel",
                 "__launch_bounds__(256, 8)\nsddmm_csr_kernel")],
        # 4 warps a block
        "warps4": [("  const int rows = warps * kWarp / kCsrGroup;",
                    "  warps = 4;\n  const int rows = warps * kWarp / "
                    "kCsrGroup;")],
        # lane groups of 16 or 32 (2 or 1 rows a warp)
        "group16": [("constexpr int kCsrGroup = 8;",
                     "constexpr int kCsrGroup = 16;")],
        "group32": [("constexpr int kCsrGroup = 8;",
                     "constexpr int kCsrGroup = 32;")],
        # pos, B and dC read past L1 (L2 only): what L1's hits are worth
        "cg": [("__ldg(", "__ldcg(")]}),
    "b5": ("maple_spgemm", {
        "base": [],
        # the pos and B gathers taken away (metadata, updates, flush kept)
        "nogather": [(B5_POS, B5_NOPOS), (B5_TAIL, B5_NOTAIL)],
        # also each slot's B row (15 entries from B's first): no metadata
        # chain past the row's record
        "skeleton": [(B5_POS, B5_NOPOS), (B5_TAIL, B5_NOTAIL),
                     ("const int2 sb = __ldg(slot_b + s0 + t0 + j);",
                      "const int2 sb = make_int2(0, 15);")],
        # a route, whatever the plan's rows: 8 lanes a row at 3 to 5
        # steps; a warp a row with 2, 4 or 8 slots in flight
        "narrow": [(B5_ENTRY, B5_ENTRY + "  route = 0;\n")],
        "narrow4": [(B5_ENTRY, B5_ENTRY + "  route = 0;\n"),
                    (B5_NARROW, "X(0, 8, 2, 4)")],
        "narrow5": [(B5_ENTRY, B5_ENTRY + "  route = 0;\n"),
                    (B5_NARROW, "X(0, 8, 2, 5)")],
        "wide": [(B5_ENTRY, B5_ENTRY + "  route = 1;\n")],
        "wide2": [(B5_ENTRY, B5_ENTRY + "  route = 1;\n"),
                  (B5_WIDE, "X(1, 32, 2, 1)")],
        "wide8": [(B5_ENTRY, B5_ENTRY + "  route = 1;\n"),
                  (B5_WIDE, "X(1, 32, 8, 1)")],
        # the most rows a block (256 threads)
        "rowsmax": [("  rows = rows < 256 / G ? rows : 256 / G;",
                     "  rows = 256 / G;")],
        # no L2 prefetch of the row's positions
        "noprefetch": [(B5_PREFETCH, "")],
        # C's values not written (the PSB still read): what the flush costs
        "noflush": [("out[c0 + p] = from_f32<T>(psb[p]);",
                     "if (psb[p] == 1.5f) out[c0 + p] = from_f32<T>(psb[p]);")],
        # registers capped for 5 blocks of 256 threads an SM
        "lb5": [(B5_LB, B5_LB.replace("(256)", "(256, 5)"))]}),
    "db": ("maple_spgemm", {
        "base": [],
        # the dC gathers taken away (index loads and FMAs kept)
        "nogather": [(DB_GATHER, DB_NOGATHER)],
        # the fiber's A values (t_perm -> A) taken away
        "nometa": [(DB_META, DB_NOMETA)],
        # both, and the index loads: the loops alone
        "skeleton": [(DB_GATHER, DB_NOGATHER), (DB_META, DB_NOMETA),
                     ("? __ldg(cpos + (size_t)t * bn + u) : -1;",
                      "? u : -1;")],
        "depth4": [("constexpr int kDbDepth = 8;",
                    "constexpr int kDbDepth = 4;")],
        "steps2": [("constexpr int kDbSteps = 3;",
                    "constexpr int kDbSteps = 2;")],
        "steps5": [("constexpr int kDbSteps = 3;",
                    "constexpr int kDbSteps = 5;")],
        # 16 lanes a B row (2 a warp)
        "group16": [("constexpr int kDbGroup = 8;",
                     "constexpr int kDbGroup = 16;")],
        "steps4": [("constexpr int kDbSteps = 3;",
                    "constexpr int kDbSteps = 4;")],

        # registers capped for 6 blocks of 256 threads an SM
        "lb6": [(DB_LB, DB_LB.replace("(256)", "(256, 6)"))],
        # 4 warps a block
        "warps4": [("  const int rows = warps * kWarp / kDbGroup;",
                    "  warps = 4;\n  const int rows = warps * kWarp / "
                    "kDbGroup;")]}),
})
# the plain version of a case, where its errors are reported (B9), and its
# output, computed once
PLAIN, WANT = {}, {}
KERNEL_NAME = {"b4": "run_kernel", "b3": "run_kernel", "b8": "moe_kernel",
               "dx": "moe_kernel", "dw": "moe_dw_kernel",
               "b2": "sddmm_kernel", "b7": "spmspm_kernel",
               "b9": "block_attn_kernel", "b6": "sddmm_csr_kernel",
               "b5": "spgemm_kernel", "db": "spgemm_db_kernel"}


def build(source, variants, names):
    """Each variant's source and a copy of ``hopper.cuh`` in a directory of
    its own; a replacement applies to the source, or to the header where
    the source does not hold its text."""
    files = {f"{source}.cu": (_build.CSRC / f"{source}.cu").read_text(),
             "hopper.cuh": (_build.CSRC / "hopper.cuh").read_text()}
    out = ROOT / "build" / "variants"
    procs = {}
    for name in names:
        texts = dict(files)
        for old, new in variants[name]:
            where = next((f for f, t in texts.items() if old in t), None)
            if where is None:
                raise SystemExit(f"{name}: {old!r} is in neither the source "
                                 f"nor hopper.cuh")
            texts[where] = texts[where].replace(old, new)
        folder = out / f"{source}-{name}"
        folder.mkdir(parents=True, exist_ok=True)
        for f, t in texts.items():
            (folder / f).write_text(t)
        path = folder / f"{source}.cu"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{source}-{name}.so"), str(path)],
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


def train_moe_operands():
    """granite-moe-3b's training products (capacity 56, E 48, gate and
    down), f32 and bf16: (tag, x, dy, w, expert_of_tile), as
    ``chip_smoke.moe_train_rows`` makes them."""
    e, cap = cs.MOE_E, cs.MOE_TRAIN_CAP
    eot = torch.arange(e, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for name, d, f in (("gate", 1536, 512), ("down", 512, 1536)):
            rng = np.random.default_rng(cs.SEED + d)
            x, dy = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda().to(dtype)
                for shape in ((e * cap, d), (e * cap, f)))
            w = torch.from_numpy((rng.standard_normal((e, d, f)) / np.sqrt(d))
                                 .astype(np.float32)).cuda().to(dtype)
            yield f"train {name} {str(dtype)[6:]}", x, dy, w, eot


def dx_cases():
    from repro_torch.kernels.moe_gemm import moe_gemm_dx, moe_gemm_dx_plain
    for tag, _, dy, w, eot in train_moe_operands():
        PLAIN[tag] = lambda dy=dy, eot=eot, w=w: moe_gemm_dx_plain(
            dy, eot, w, bt=cs.MOE_TRAIN_CAP)
        yield (tag, lambda dy=dy, eot=eot, w=w: moe_gemm_dx(
            dy, eot, w, bt=cs.MOE_TRAIN_CAP))


def dw_cases():
    from repro_torch.kernels.moe_gemm import moe_gemm_dw, moe_gemm_dw_plain
    for tag, x, dy, _, eot in train_moe_operands():
        PLAIN[tag] = lambda x=x, dy=dy, eot=eot: moe_gemm_dw_plain(
            x, dy, eot, cs.MOE_E, bt=cs.MOE_TRAIN_CAP)
        yield (tag, lambda x=x, dy=dy, eot=eot: moe_gemm_dw(
            x, dy, eot, cs.MOE_E, bt=cs.MOE_TRAIN_CAP))


def b2_cases():
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr
    rng = np.random.default_rng(cs.SEED + 3)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
        for shape in (cs.TRAIN_MLP, cs.TRAIN_HEAD):
            w = cs.sparse_weight(gen, shape, dtype)
            g, n = shape["G"], shape["N"][0]
            args = cs.run_sddmm_case(w, g, n, dtype, 128, rng)[2]
            yield (f"{shape['name'][:8]} N={n} {str(dtype)[6:]}",
                   lambda args=args: maple_sddmm_bsr(*args, bm=64, bk=64))


def b7_cases():
    from repro_torch.core import sparsity
    from repro_torch.core.formats import csr_to_ell
    from repro_torch.kernels.maple_spmspm import maple_spmspm_ell
    a = sparsity.generate(sparsity.TABLE_I[cs.CAGE12], scale=cs.CAGE12_SCALE,
                          seed=cs.SEED, device="cuda")
    values, col_ids = csr_to_ell(a)
    dense_b = torch.from_numpy(np.random.default_rng(cs.SEED + 9)
                               .standard_normal((a.shape[0], cs.SPMSPM_N))
                               .astype(np.float32)).cuda()
    yield (f"cage12 ELL {tuple(values.shape)} x N={cs.SPMSPM_N} float32",
           lambda: maple_spmspm_ell(values, col_ids, dense_b))


def b9_cases():
    from repro_torch.kernels import local_window_kv_map
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    a = cs.ATTN
    b, s, h, hd = a["B"], a["S"], a["H"], a["hd"]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    k, v = [torch.randn((b, s, 1, hd), generator=gen, device="cuda")
            .expand(b, s, h, hd).contiguous() for _ in range(2)]
    kv_map = torch.from_numpy(local_window_kv_map(
        s, a["window"], a["bq"], a["bk"])).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        args = [x.to(dtype) for x in (q, k, v)] + [kv_map]
        name = f"recurrentgemma-9b {str(dtype)[6:]}"
        PLAIN[name] = lambda args=args: block_attention_plain(
            *args, bq=a["bq"], bk=a["bk"], window=a["window"])
        yield (name, lambda args=args: block_attention(
            *args, bq=a["bq"], bk=a["bk"], window=a["window"]))


SPGEMM = {}


def spgemm_operands():
    """C = A×A on the cage12 and poisson3Da clones: (tag, A, plan, dC),
    planned once per process."""
    from repro_torch.core import sparsity
    from repro_torch.kernels import plan_spgemm
    if not SPGEMM:
        for tag in (cs.CAGE12, "p3"):
            a = sparsity.generate(sparsity.TABLE_I[tag], scale=1.0,
                                  seed=cs.SEED, device="cuda")
            plan = plan_spgemm(a, a)
            dc = torch.from_numpy(np.random.default_rng(cs.SEED + 10)
                                  .standard_normal(plan.nnz_c)
                                  .astype(np.float32)).cuda()
            SPGEMM[tag] = (a, plan, dc)
    return SPGEMM.items()


def b6_cases():
    from repro_torch.kernels.maple_sddmm import maple_sddmm_csr
    for tag, (a, plan, dc) in spgemm_operands():
        yield (f"{tag} C=A×A dA float32",
               lambda a=a, plan=plan, dc=dc: maple_sddmm_csr(
                   dc, a.value, plan, n_slots=a.nnz))


def b5_cases():
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_numeric,
                                                  maple_spgemm_numeric_plain)
    for tag, (a, plan, _) in spgemm_operands():
        name = f"{tag} C=A×A float32"
        PLAIN[name] = lambda a=a, plan=plan: maple_spgemm_numeric_plain(
            a.value, a.value, plan, cap=plan.nnz_c)
        yield (name, lambda a=a, plan=plan: maple_spgemm_numeric(
            a.value, a.value, plan, cap=plan.nnz_c))


def db_cases():
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_db_plain)
    for tag, (a, plan, dc) in spgemm_operands():
        name = f"{tag} C=A×A dB float32"
        PLAIN[name] = lambda a=a, plan=plan, dc=dc: maple_spgemm_db_plain(
            dc, a.value, plan, n_slots=a.nnz)
        yield (name, lambda a=a, plan=plan, dc=dc: maple_spgemm_db(
            dc, a.value, plan, n_slots=a.nnz))


def errors(got, want):
    """A variant's output against the plain version: max|got - want| over
    ``chip_smoke.check_close``'s limit, and in bf16 ``row_rel_err`` over
    ``check_rows``'s (above 1: the check fails)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    if got.dtype == torch.float32:
        return {"close": float((g - w).abs().max()) / (1e-5 * scale + 1e-6)}
    return {"close": float((g - w).abs().max()) / (1e-2 * scale),
            "rows": cs.row_rel_err(got, want) / cs.ROW_LIMIT}


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
    cases = list({"b4": b4_cases, "b3": b3_cases, "b8": b8_cases,
                  "dx": dx_cases, "dw": dw_cases, "b2": b2_cases, "b7": b7_cases, "b9": b9_cases,
                  "b6": b6_cases, "b5": b5_cases,
                  "db": db_cases}[args.kernel]())
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
                if name in PLAIN:
                    if name not in WANT:
                        WANT[name] = PLAIN[name]()
                    res[name][variant].append(errors(fn(), WANT[name]))
            except RuntimeError as err:               # e.g. a ring too small
                res[name][variant] = str(err)[:80]
    print("variant: [events ms, profiler device ms, errors against the "
          "plain version (B9)]", flush=True)
    for name, row in res.items():
        print(name, json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
