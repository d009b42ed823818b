#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — requires CUDA, prints the card's name and power limit (as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them) and builds the CUDA kernels into ``build/kernels/`` (one ``nvcc``
   per source, all started together).
2. kernels — holds each Hopper kernel against its plain PyTorch version on
   the card:
   - small edge cases: 8×8 blocks, bn = 16, ragged N, empty rows, pad
     blocks, an all-empty (all-pad) matrix, G > 1, a plan with idle lanes
     and split rows; the SpMM merge and the SDDMM each run twice for bit
     identity;
   - the serving shapes of the SpMM kernels (the qwen3-4b MLP
     down-projection and the sparse logit head);
   - the training shapes: the block SDDMM (dA) and the compact kernel on
     the transpose-side plan (dB) of the MLP down-projection at G=1,
     N=256 and of the head at G=1, N=4, and the compact kernel on the
     MLP's forward plan at G=1, N=256 (the train path's forward and remat
     recompute);
   each in f32 and bf16, after an L2 flush.  Prints kernel, plain, library
   (one dense ``torch.matmul``) and bound times.
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
5. train_reference — the qwen3-4b smoke config with a sparse MLP at
   (8, 8) blocks: the loss and every gradient of one batch on the card
   against the same weights and batch on the CPU (plain path), then one
   ``make_train_step`` step on both (parameters within 2·lr).
6. train   — ``repro_torch.launch.train`` on qwen3-4b at full width and
   depth with ``--sparse-mlp``, f32, seed 0, 4 × 256 tokens in 4
   microbatches, 3 AdamW steps.  Launch counts are zeroed just before and
   read just after and must equal the derived count: per layer and
   microbatch, the compact kernel for the forward, the remat recompute
   and dB, the SDDMM once for dA.  Prints loss and grad norm per step,
   the step ms of steps 2 and 3, tokens/s, the peak GiB and one profiled
   step.
7. head_backward — a backward through a full-size
   ``SparseLogitHead.build(trainable=True)``, its grads held against the
   kernels' plain versions on the card.
8. spgemm_kernels — the SpGEMM numeric phase (B5), its CSR SDDMM (B6) and
   dB, and the element walk with a dense B (B7) against their plain
   versions on the card, f32 and bf16, over the element-pattern goldens
   and edge cases (empty rows, an all-zero A, nnz at capacity,
   zero-dimension operands, la = 1, lc = 1, pad steps, rows and panels
   wider than a warp); B5, B6 and dB twice each for bit identity.
9. spgemm  — the paper's protocol C = A×A on the cage12 clone at scale
   1.0 (seed 0; its n, nnz, la, lb, lc, P and nnz(C) are printed; the
   clone's rng takes the string hashes of the process, so the script
   re-runs itself with ``PYTHONHASHSEED=0`` unless it is set): the host plan
   timed, ``maple_spgemm`` forward and the backward of sum(C²) with the
   launch counts zeroed just before and read just after (one B5, one B6,
   one dB), C held against scipy's A @ A (pattern and values) and against
   the plain path on the card, the gradient against the plain versions,
   and warm forward and forward + backward times; then
   ``maple_spmspm(A, B)`` with a dense (n, 64) B (one B7 launch, against
   scipy); then the four kernels timed at these shapes beside
   their bounds, plain versions and ``torch.sparse.mm`` (cuSPARSE).
10. the ``{"kernels": [...]}`` summary, then the final
    ``{"ok": true, ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
SOURCES = {"maple_spmm_naive": "src/repro_torch/csrc/maple_spmm.cu",
           "maple_spmm_compact": "src/repro_torch/csrc/maple_spmm.cu",
           "maple_sddmm_bsr": "src/repro_torch/csrc/maple_sddmm.cu",
           "maple_spgemm_numeric": "src/repro_torch/csrc/maple_spgemm.cu",
           "maple_sddmm_csr": "src/repro_torch/csrc/maple_spgemm.cu",
           "maple_spgemm_db": "src/repro_torch/csrc/maple_spgemm.cu",
           "maple_spmspm_ell": "src/repro_torch/csrc/maple_spmspm.cu"}
# dB has no TPU kernel: the reference leaves it to an XLA scatter-add
REPLACES = {"maple_spmm_naive": "src/repro/kernels/maple_spmm.py:91",
            "maple_spmm_compact": "src/repro/kernels/maple_spmm.py:288",
            "maple_sddmm_bsr": "src/repro/kernels/maple_sddmm.py:124",
            "maple_spgemm_numeric": "src/repro/kernels/maple_spgemm.py:92",
            "maple_sddmm_csr": "src/repro/kernels/maple_sddmm.py:214",
            "maple_spgemm_db": "src/repro/kernels/ops.py:934",
            "maple_spmspm_ell": "src/repro/kernels/maple_spmspm.py:61"}
# the serving shapes of the kernels: the qwen3-4b MLP down-projection
# (d_ff -> d_model) as sparse_mlp builds it, over a batch of 4 sequences
# (G) at decode (N = 1 token) and prefill (N = 128 tokens); the sparse
# logit head (d_model -> padded vocab) as the serve benchmark builds it,
# one request at a time
MLP = dict(name="mlp_down 2560x9728 (64,64) d=0.25", d_out=2560, d_in=9728,
           block=(64, 64), density=0.25, G=4, N=(1, 128))
HEAD = dict(name="logit_head 153600x2560 (64,64) d=0.5 L=8", d_out=153_600,
            d_in=2560, block=(64, 64), density=0.5, n_lanes=8, G=1, N=(1, 4))
# the training shapes: the same weights at the activations of one
# microbatch of the train phase (1 × 256 tokens) and of the head check
# (1 × 4 tokens); dA and dB of y = x·Wᵀ are the SDDMM over (dC, x) and the
# compact kernel on Wᵀ over dC
TRAIN_MLP = dict(MLP, G=1, N=(256,))
TRAIN_HEAD = dict(HEAD, G=1, N=(4,))
SERVE_ARCH = "qwen3-4b"
# the SpGEMM slice: C = A×A on the paper's cage12 clone at full size
# (Table I: n 130 000, nnz 2.0 M), and A times a dense (n, 64) B
CAGE12, CAGE12_SCALE = "cg", 1.0
SPMSPM_N = 64
TRAIN_ARGV = ["--arch", "qwen3-4b", "--sparse-mlp", "--steps", "3",
              "--global-batch", "4", "--seq-len", "256", "--seed", "0",
              "--device", "cuda"]
REPS = 20
# (HBM bytes/s, {operand type: peak FLOP/s}) from NVIDIA's data sheets:
# f32 operands at the FP32 rate outside the tensor cores, bf16 operands
# (accumulated in f32) at the dense bf16 tensor-core rate
CARD_SPECS = {
    "H100 PCIe": (2.0e12, {torch.float32: 51e12, torch.bfloat16: 756e12}),
    "H100 NVL": (3.9e12, {torch.float32: 60e12, torch.bfloat16: 835e12}),
    "H100": (3.35e12, {torch.float32: 67e12, torch.bfloat16: 989e12}),
    "H200": (4.8e12, {torch.float32: 67e12, torch.bfloat16: 989e12})}


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
    t_bytes, t_ops = nbytes / spec[0] * 1e3, flops / spec[1][dtype] * 1e3
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


def run_sddmm_case(a, g, n, dtype, bn, rng):
    """The SDDMM of ``a``'s pattern on random (dC, B); checks that two
    launches give the same bits."""
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_bsr,
                                                 maple_sddmm_bsr_plain)
    bm, bk = a.block_shape
    rand = lambda rows: torch.from_numpy(rng.standard_normal(
        (g, rows, n)).astype(np.float32)).cuda().to(dtype)
    dc, b3 = rand(a.shape[0]), rand(a.shape[1])
    meta = {k: torch.from_numpy(getattr(a, k)).cuda()
            for k in ("block_row", "block_col")}
    args = (dc, b3, meta["block_row"], meta["block_col"])
    got = [maple_sddmm_bsr(*args, bm=bm, bk=bk, bn=bn) for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(got[0], got[1]):
        raise AssertionError("SDDMM is not bit-identical over two runs")
    if bool((got[0][meta["block_col"] < 0] != 0).any()):
        raise AssertionError("SDDMM wrote a non-zero pad slot")
    return got[0], maple_sddmm_bsr_plain(*args, bm=bm, bk=bk), args


def sddmm_edge_cases():
    rng = np.random.default_rng(SEED + 2)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for kw in (dict(), dict(empty_rows=True, extra_pad=3),
                   dict(density=0.0, extra_pad=2)):
            a = bsr(rng, 6, 5, 8, 8, kw.pop("density", 0.45), dtype=dtype,
                    **kw)
            for g, n in ((1, 1), (3, 21), (2, 40)):
                got, want, _ = run_sddmm_case(a, g, n, dtype, 16, rng)
                check_close(got, want, dtype, f"sddmm edge {kw} g{g} n{n}")
                cases += 1
    return cases


def training_shapes(spec, flush):
    """dA (the SDDMM) and dB (the compact kernel on the transpose-side
    plan) of the MLP down-projection and the head, at the training
    activations."""
    from repro_torch.core.csr import bsr_transpose
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_bsr,
                                                 maple_sddmm_bsr_plain)
    from repro_torch.kernels.schedule import plan_spmm_vjp
    rng = np.random.default_rng(SEED + 3)
    rows, plans = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dtype).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        for shape in (TRAIN_MLP, TRAIN_HEAD):
            w = sparse_weight(gen, shape, dtype)
            t0 = time.perf_counter()
            train = plan_spmm_vjp(w, n_lanes=shape.get("n_lanes", 8))
            plans[shape["name"]] = {"plan_spmm_vjp_s":
                                    time.perf_counter() - t0,
                                    "bwd_runs": int(train.bwd.runs.shape[0]),
                                    "fwd_runs": int(train.fwd.runs.shape[0])}
            bm, bk = w.block_shape
            g, n = shape["G"], shape["N"][0]
            live = w.nnzb * bm * bk
            # dA: (dC, B) -> (n_blocks, bm, bk) f32
            got, want, args = run_sddmm_case(w, g, n, dtype, 128, rng)
            dc, b3 = args[:2]
            nbytes = (g * (w.shape[0] + w.shape[1]) * n * isz
                      + w.n_blocks_max * (bm * bk * 4 + 8))
            rows.append(measure(
                "maple_sddmm_bsr", got, want, dtype,
                lambda: maple_sddmm_bsr(*args, bm=bm, bk=bk),
                lambda: maple_sddmm_bsr_plain(*args, bm=bm, bk=bk),
                lambda: torch.matmul(dc, b3.transpose(1, 2)), nbytes,
                2 * live * g * n, spec, flush, REPS, G=g, N=n,
                shape=shape["name"]))
            del got, want, args, dc, b3
            if shape is TRAIN_MLP:
                rows.append(compact_row(w, train.fwd, g, n, dtype, isz,
                                        spec, flush, rng,
                                        f"{shape['name']} forward"))
            # dB: Aᵀ on the transpose-side plan over dC
            rows.append(compact_row(bsr_transpose(w), train.bwd, g, n, dtype,
                                    isz, spec, flush, rng,
                                    f"{shape['name']} transposed (dB)"))
            del w
            torch.cuda.empty_cache()
    return rows, plans


def compact_row(a, plan, g, n, dtype, isz, spec, flush, rng, name):
    """The compact kernel on ``plan`` over ``a`` at the training
    activations: tiles and merge held against the plain versions, then
    timed."""
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_compact_plain)
    tiles, want_tiles, merged, want_merged, cargs, n_slots, b3 = \
        run_compact_case(a, plan, g, n, dtype, 128, rng)
    check_close(merged, want_merged, dtype, f"merge {name}")
    n_live = int((plan.slot_row >= 0).sum())
    nbytes, flops = spmm_cost(
        a, g, n, isz, out_bytes=g * n_live * plan.block_m * n * 4,
        meta_bytes=4 * 2 * plan.order.size + 16 * plan.runs.shape[0])
    dense = a.to_dense()
    row = measure(
        "maple_spmm_compact", tiles, want_tiles, dtype,
        lambda: maple_spmm_compact(*cargs, n_slots=n_slots, bn=128),
        lambda: maple_spmm_compact_plain(*cargs, n_slots=n_slots),
        lambda: torch.matmul(dense, b3), nbytes, flops, spec, flush, REPS,
        G=g, N=n, shape=name)
    row["runs"] = int(plan.runs.shape[0])
    return row


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


# --------------------------------------------------------------------------
# phase 5: one train step of the smoke config, card against CPU
# --------------------------------------------------------------------------

def grads_close(got, want, what):
    """Within 1e-4·max|want| + 1e-6: f32 sums in another order through a
    whole model (the CPU parity tests' tolerance)."""
    err = float((got.float().cpu() - want.float()).abs().max())
    limit = 1e-4 * float(want.abs().max()) + 1e-6
    if not err <= limit:
        raise AssertionError(f"{what}: max|card - cpu| = {err} > {limit}")
    return err


def train_reference():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import lm
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.optimizer import named_leaves, tree_map
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), sparse_mlp=True,
                              sparse_block=(8, 8))
    cpu = lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(SEED), device="cpu"))
    to_cuda = lambda tree: tree_map(lambda t: t.detach().cuda(), tree)
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=SEED), 0)
    grads, losses = {}, {}
    for name, params, dev in (("cpu", cpu, "cpu"),
                              ("cuda", to_cuda(cpu), "cuda")):
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        loss, _ = lm.loss_fn(params, cfg, {k: v.to(dev) for k, v in
                                           batch.items()},
                             mlp_plan=lm.sparse_mlp_plan(params))
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {k: t.grad.detach().cpu().clone()
                       for k, t in named_leaves(params)}
    if not abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"]):
        raise AssertionError(f"card loss {losses['cuda']} != cpu "
                             f"{losses['cpu']}")
    grad_err = max(grads_close(grads["cuda"][k], g, f"grad {k}")
                   for k, g in grads["cpu"].items())
    # one optimizer step of the train step on both, from the same weights
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=10)
    after = {}
    for name, dev in (("cpu", "cpu"), ("cuda", "cuda")):
        params = tree_map(lambda t: t.detach().to(dev).clone(), cpu)
        step = make_train_step(cfg, ocfg, 2,
                               mlp_plan=lm.sparse_mlp_plan(params))
        params, _, m = step(params, init_opt_state(ocfg, params),
                            {k: v.to(dev) for k, v in batch.items()})
        after[name] = {k: t.detach() for k, t in named_leaves(params)}
    lr = float(m["lr"])
    param_err = max(float((after["cuda"][k].cpu() - p).abs().max())
                    for k, p in after["cpu"].items())
    if not param_err <= 2 * lr:
        raise AssertionError(f"params after one step differ by {param_err} "
                             f"> 2·lr = {2 * lr}")
    return {"phase": "train_reference", "config": "qwen3-4b smoke, "
            "sparse_mlp (8,8), 4 x 16 tokens, 2 microbatches",
            "loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"],
            "grad_max_abs_err": grad_err, "n_grads": len(grads["cpu"]),
            "param_max_abs_err_after_step": param_err, "lr": lr}


# --------------------------------------------------------------------------
# phase 6: train qwen3-4b at full width and depth
# --------------------------------------------------------------------------

def train(card):
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_naive)
    from repro_torch.launch import train as launch_train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    maple_spmm_naive.launches = 0
    maple_spmm_compact.launches = 0
    maple_sddmm_bsr.launches = 0
    t0 = time.perf_counter()
    run = launch_train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"maple_spmm_naive": maple_spmm_naive.launches,
                "maple_spmm_compact": maple_spmm_compact.launches,
                "maple_sddmm_bsr": maple_sddmm_bsr.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = run.cfg
    steps, tokens = len(run.history), 4 * 256
    micro = cfg.train_microbatches
    # per layer and microbatch: the MLP forward, its remat recompute and
    # dB on the compact kernel; dA on the SDDMM
    per_layer = 3 if cfg.remat else 2
    expect = {"maple_spmm_naive": 0,
              "maple_spmm_compact": steps * micro * cfg.n_layers * per_layer,
              "maple_sddmm_bsr": steps * micro * cfg.n_layers}
    if launches != expect:
        raise AssertionError(f"kernel launches on the train path "
                             f"{launches}, expected {expect}")
    for rec in run.history:
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])):
            raise AssertionError(f"non-finite step {rec}")
    step_ms = [rec["step_s"] * 1e3 for rec in run.history]
    # one more step, outside the counted run, under the profiler
    from repro_torch.data import synth_batch
    batch = {k: v.cuda() for k, v in synth_batch(run.data, steps).items()}
    prof = profile(lambda: run.step_fn(run.params, run.opt, batch),
                   warmup=False)
    return launches, {
        "phase": "train", "config": "qwen3-4b sparse_mlp (64,64) d=0.25, "
        "f32, AdamW, remat per layer", "argv": TRAIN_ARGV,
        "n_layers": cfg.n_layers, "depth_reduced": False,
        "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "vocab_size": cfg.vocab_size, "microbatches": micro,
        "tokens_per_step": tokens,
        "loss": [rec["loss"] for rec in run.history],
        "grad_norm": [rec["grad_norm"] for rec in run.history],
        "step_ms": step_ms, "step_ms_2_3": step_ms[1:3],
        "tok_per_s_2_3": [tokens / (ms / 1e3) for ms in step_ms[1:3]],
        "run_s": total_s, "peak_mem_gib": peak_gib, "launches": launches,
        "launches_expected": expect, "card": card, "profile": prof}


# --------------------------------------------------------------------------
# phase 7: backward through a full-size trainable sparse head
# --------------------------------------------------------------------------

def head_backward():
    from repro_torch.core.csr import transpose_payload
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_bsr,
                                                 maple_sddmm_bsr_plain)
    from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                                maple_spmm_compact_plain)
    from repro_torch.kernels.ops import _scatter_merge_f32
    from repro_torch.models.layers import init_sparse_linear
    from repro_torch.serve import SparseLogitHead
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    w = init_sparse_linear(gen, HEAD["d_in"], HEAD["d_out"],
                           block_shape=HEAD["block"],
                           block_density=HEAD["density"])
    t0 = time.perf_counter()
    head = SparseLogitHead.build(w, n_lanes=HEAD["n_lanes"], trainable=True)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 5)
    hidden = torch.from_numpy(rng.standard_normal((1, 4, HEAD["d_in"]))
                              .astype(np.float32)).cuda().requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((1, 4, HEAD["d_out"]))
                           .astype(np.float32)).cuda()
    blocks = w.blocks.clone().requires_grad_()
    trained = SparseLogitHead(weight=dataclasses.replace(w, blocks=blocks),
                              plan=head.plan)
    before = (maple_spmm_compact.launches, maple_sddmm_bsr.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (trained(hidden) * cot).sum().backward()
    torch.cuda.synchronize()
    fwd_bwd_ms = (time.perf_counter() - t0) * 1e3
    launched = (maple_spmm_compact.launches - before[0],
                maple_sddmm_bsr.launches - before[1])
    if launched != (2, 1):
        raise AssertionError(f"head forward+backward launched {launched} "
                             f"(compact, sddmm), expected (2, 1)")
    # the same two gradients from the kernels' plain versions
    train = head.plan
    d = train.on_device(cot.device)
    bm, bk = w.block_shape
    dc = cot.transpose(1, 2).contiguous()                  # (1, V, 4)
    b3 = hidden.detach().transpose(1, 2).contiguous()      # (1, D, 4)
    at = transpose_payload(w.blocks, d["t_perm"], w.n_blocks_max)
    bwd = train.bwd.on_device(dc.device)
    n_slots = train.bwd.n_lanes * train.bwd.r_max
    tiles = maple_spmm_compact_plain(at, bwd["order"], bwd["step_col"],
                                     bwd["runs"], dc, n_slots=n_slots)
    db = _scatter_merge_f32(tiles.view(1, n_slots, bk, 4), bwd["merge"],
                            gm=train.bwd.n_block_rows)
    da = maple_sddmm_bsr_plain(dc, b3, d["block_row"], d["block_col"],
                               bm=bm, bk=bk)
    err_x = check_close(hidden.grad, db.transpose(1, 2), torch.float32,
                        "head dhidden")
    err_w = check_close(blocks.grad, da, torch.float32, "head dW")
    return {"phase": "head_backward", "shape": HEAD["name"], "G": 1, "N": 4,
            "plan_spmm_vjp_s": build_s, "fwd_runs": int(train.fwd.runs
                                                        .shape[0]),
            "bwd_runs": int(train.bwd.runs.shape[0]),
            "fwd_bwd_ms": fwd_bwd_ms, "dhidden_max_abs_err": err_x,
            "dW_max_abs_err": err_w}


# --------------------------------------------------------------------------
# phase 8: the SpGEMM kernels against their plain versions
# --------------------------------------------------------------------------

def element_csr(mask, rng, dtype, pad=0):
    from repro_torch.core.csr import CSR
    d = (mask * rng.standard_normal(mask.shape)).astype(np.float32)
    c = CSR.from_dense(d, nnz_max=max(int(mask.sum()), 1) + pad,
                       device="cuda")
    return dataclasses.replace(c, value=c.value.to(dtype))


def spgemm_edge_operands(rng):
    """(name, A mask, B mask, n_lanes, at capacity): the element-pattern
    goldens, empty rows, an all-zero A, nnz exactly at capacity,
    zero-dimension operands, la = 1, lc = 1, pad steps (more lanes than
    rows), and rows and panels wider than a warp (la, lb > 32)."""
    from repro_torch.core.sparsity import element_pattern_mask
    cases = [(f"{kind}", element_pattern_mask(kind, rng, 40, 36),
              element_pattern_mask(kind, rng, 36, 44), 8, False)
             for kind in ("uniform", "power_law", "banded")]
    empty = rng.random((30, 20)) < 0.3
    empty[::3] = False
    one = np.zeros((24, 20), bool)
    one[np.arange(24), rng.integers(0, 20, 24)] = True
    diag = np.zeros((20, 20), bool)
    diag[np.arange(20), rng.permutation(20)] = True
    cases += [
        ("empty_rows", empty, rng.random((20, 26)) < 0.3, 3, False),
        ("all_zero_a", np.zeros((12, 10), bool), rng.random((10, 9)) < 0.5,
         2, False),
        ("at_capacity", rng.random((18, 15)) < 0.4,
         rng.random((15, 17)) < 0.4, 4, True),
        ("zero_m", np.zeros((0, 5), bool), rng.random((5, 4)) < 0.5, 8,
         False),
        ("zero_k", np.zeros((4, 0), bool), np.zeros((0, 5), bool), 8, False),
        ("zero_n", rng.random((5, 4)) < 0.5, np.zeros((4, 0), bool), 8,
         False),
        ("la_1", one, rng.random((20, 30)) < 0.3, 8, False),
        ("lc_1", diag, diag.copy(), 8, False),
        ("pad_steps", rng.random((3, 12)) < 0.5, rng.random((12, 10)) < 0.4,
         8, False),
        ("wide", rng.random((6, 80)) < 0.9, rng.random((80, 90)) < 0.9, 3,
         False)]
    return cases


def spgemm_kernels_edge():
    """B5, B6, dB and B7 against their plain versions on the edge cases,
    f32 and bf16; B5, B6 and dB twice each for bit identity."""
    from repro_torch.core.csr import grow_nnz_max
    from repro_torch.core.formats import csr_to_ell
    from repro_torch.kernels import maple_spgemm, plan_spgemm
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_csr,
                                                 maple_sddmm_csr_plain)
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_db_plain,
                                                  maple_spgemm_numeric,
                                                  maple_spgemm_numeric_plain)
    from repro_torch.kernels.maple_spmspm import (maple_spmspm_ell,
                                                  maple_spmspm_ell_plain)
    rng = np.random.default_rng(SEED + 8)
    cases = bit_equal_plain = 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, am, bm, lanes, at_cap in spgemm_edge_operands(rng):
            a = element_csr(am, rng, dtype, pad=0 if at_cap else 2)
            b = element_csr(bm, rng, dtype, pad=0 if at_cap else 3)
            plan = plan_spgemm(a, b, n_lanes=lanes)
            cap = plan.nnz_c if at_cap else grow_nnz_max(plan.nnz_c)
            what = f"{name} {dtype}"
            if plan.nnz_c == 0:
                before = maple_spgemm_numeric.launches
                c = maple_spgemm(a, b, plan=plan)
                if maple_spgemm_numeric.launches != before or bool(
                        c.value.any()):
                    raise AssertionError(f"{what}: nnz(C) = 0 launched B5 "
                                         f"or gave a non-zero value")
                cases += 1
                continue
            got = [maple_spgemm_numeric(a.value, b.value, plan, cap=cap)
                   for _ in range(2)]
            torch.cuda.synchronize()
            want = maple_spgemm_numeric_plain(a.value, b.value, plan,
                                              cap=cap)
            if not torch.equal(got[0], got[1]):
                raise AssertionError(f"B5 {what}: two runs differ")
            if bool(got[0][plan.nnz_c:].any()):
                raise AssertionError(f"B5 {what}: non-zero capacity slot")
            check_close(got[0], want, dtype, f"B5 {what}")
            bit_equal_plain += bool(torch.equal(got[0], want))
            dc = torch.from_numpy(rng.standard_normal(cap).astype(
                np.float32)).cuda().to(dtype)
            for kernel, plain, other, n in (
                    (maple_sddmm_csr, maple_sddmm_csr_plain, b.value,
                     a.nnz_max),
                    (maple_spgemm_db, maple_spgemm_db_plain, a.value,
                     b.nnz_max)):
                got = [kernel(dc, other, plan, n_slots=n) for _ in range(2)]
                torch.cuda.synchronize()
                if not torch.equal(got[0], got[1]):
                    raise AssertionError(f"{kernel.__name__} {what}: two "
                                         f"runs differ")
                check_close(got[0], plain(dc, other, plan, n_slots=n),
                            dtype, f"{kernel.__name__} {what}")
            values, col_ids = csr_to_ell(a)
            dense_b = b.to_dense()
            got = maple_spmspm_ell(values, col_ids, dense_b)
            torch.cuda.synchronize()
            check_close(got, maple_spmspm_ell_plain(values, col_ids, dense_b),
                        dtype, f"B7 {what}")
            cases += 1
    return {"phase": "spgemm_kernels", "cases": cases,
            "b5_bit_equal_to_plain": bit_equal_plain, "ok": True}


# --------------------------------------------------------------------------
# phase 9: C = A×A on the full-size cage12 clone, forward and backward
# --------------------------------------------------------------------------

SPGEMM_COUNTERS = ("maple_spgemm_numeric", "maple_sddmm_csr",
                   "maple_spgemm_db", "maple_spmspm_ell")


def spgemm_counters():
    from repro_torch.kernels.maple_sddmm import maple_sddmm_csr
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_numeric)
    from repro_torch.kernels.maple_spmspm import maple_spmspm_ell
    return dict(zip(SPGEMM_COUNTERS, (maple_spgemm_numeric, maple_sddmm_csr,
                                      maple_spgemm_db, maple_spmspm_ell)))


def counted(fn):
    """Run ``fn`` with the SpGEMM launch counts zeroed just before; return
    its result, the counts just after and the wall ms (synchronised)."""
    fns = spgemm_counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {k: f.launches for k, f in fns.items()}, ms


def scipy_csr(c):
    import scipy.sparse as sp
    nnz = c.nnz
    return sp.csr_matrix((c.value[:nnz].detach().float().cpu().numpy(),
                          c.col_id[:nnz], c.row_ptr), shape=c.shape)


def spgemm(spec, flush, card):
    """``maple_spgemm(A, A)`` on cage12 at scale 1.0, forward and backward
    of sum(C²), against scipy (pattern and values) and the plain path on
    the card; then ``maple_spmspm(A, B)`` with a dense (n, 64) B; then the
    four kernels timed at these shapes."""
    from repro_torch.core import sparsity
    from repro_torch.kernels import maple_spgemm, maple_spmspm, plan_spgemm
    from repro_torch.kernels.maple_sddmm import maple_sddmm_csr_plain
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db_plain,
                                                  maple_spgemm_numeric_plain)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a = sparsity.generate(sparsity.TABLE_I[CAGE12], scale=CAGE12_SCALE,
                          seed=SEED, device="cuda")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_spgemm(a, a)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan.on_device(a.value.device)
    torch.cuda.synchronize()
    device_plan_s = time.perf_counter() - t0
    stats = {"n": a.shape[0], "nnz": a.nnz, "la": plan.la, "lb": plan.lb,
             "lc": plan.lc, "P": plan.stats.partial_products,
             "nnz_c": plan.nnz_c}
    cap = plan.nnz_c

    value = a.value.clone().requires_grad_()
    op = dataclasses.replace(a, value=value)
    torch.cuda.reset_peak_memory_stats()
    c, fwd_launches, fwd_ms = counted(
        lambda: maple_spgemm(op, op, plan=plan, nnz_max=cap))
    _, bwd_launches, bwd_ms = counted(
        lambda: (c.value * c.value).sum().backward())
    launches = {k: fwd_launches[k] + bwd_launches[k] for k in fwd_launches}
    expect = {"maple_spgemm_numeric": 1, "maple_sddmm_csr": 1,
              "maple_spgemm_db": 1, "maple_spmspm_ell": 0}
    if launches != expect or fwd_launches["maple_sddmm_csr"]:
        raise AssertionError(f"SpGEMM launches {fwd_launches} forward, "
                             f"{bwd_launches} backward; expected {expect}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(c.value).all()):
        raise AssertionError("non-finite C")

    # scipy's A @ A on the host: its pattern lies in the plan's, its values
    # agree at the pattern
    ref = scipy_csr(a) @ scipy_csr(a)
    ref.sort_indices()
    got = scipy_csr(c)
    n = a.shape[0]
    keys = lambda m: (np.repeat(np.arange(n, dtype=np.int64),
                                np.diff(m.indptr)) * n + m.indices)
    if not np.isin(keys(ref), keys(got)).all():
        raise AssertionError("scipy's A @ A has coordinates outside the "
                             "plan's pattern")
    scale = float(np.abs(ref.data).max())
    sci_err = float(np.abs((got - ref).data).max(initial=0.0))
    if not sci_err <= 1e-5 * scale + 1e-6:
        raise AssertionError(f"C against scipy: {sci_err} > "
                             f"{1e-5 * scale + 1e-6}")
    # the plain path on the card, on the same values
    want = maple_spgemm_numeric_plain(a.value, a.value, plan, cap=cap)
    fwd_err = check_close(c.value.detach(), want, torch.float32,
                          "C against plain")
    dc = (2 * want).contiguous()
    want_grad = (maple_sddmm_csr_plain(dc, a.value, plan, n_slots=a.nnz_max)
                 + maple_spgemm_db_plain(dc, a.value, plan,
                                         n_slots=a.nnz_max))
    grad_err = check_close(value.grad, want_grad, torch.float32,
                           "dA + dB against plain")
    # warm end-to-end times, outside the counted run
    fwd_warm = statistics.median(counted(
        lambda: maple_spgemm(a, a, plan=plan, nnz_max=cap))[2]
        for _ in range(3))

    def fwd_bwd():
        c2 = maple_spgemm(op, op, plan=plan, nnz_max=cap)
        (c2.value * c2.value).sum().backward()
    fwd_bwd_warm = statistics.median(counted(fwd_bwd)[2] for _ in range(3))
    del c, want, want_grad, value, op
    torch.cuda.empty_cache()

    # maple_spmspm with a dense B: the element walk (B7)
    rng = np.random.default_rng(SEED + 9)
    dense_b = torch.from_numpy(rng.standard_normal(
        (n, SPMSPM_N)).astype(np.float32)).cuda()
    out, mm_launches, mm_ms = counted(lambda: maple_spmspm(a, dense_b))
    if mm_launches != {"maple_spgemm_numeric": 0, "maple_sddmm_csr": 0,
                       "maple_spgemm_db": 0, "maple_spmspm_ell": 1}:
        raise AssertionError(f"maple_spmspm launches {mm_launches}")
    ref_mm = scipy_csr(a) @ dense_b.cpu().numpy()
    mm_err = float((out.cpu() - torch.from_numpy(ref_mm)).abs().max())
    if not mm_err <= 1e-5 * float(np.abs(ref_mm).max()) + 1e-6:
        raise AssertionError(f"maple_spmspm against scipy: {mm_err}")
    del out
    rows = spgemm_rows(a, plan, dense_b, spec, flush)
    line = {"phase": "spgemm", "matrix": f"{CAGE12} clone, scale "
            f"{CAGE12_SCALE}, seed {SEED}, PYTHONHASHSEED "
            f"{os.environ.get('PYTHONHASHSEED')}", **stats, "generate_s": gen_s,
            "plan_spgemm_s": plan_s,
            "on_device_s": device_plan_s, "launches": launches,
            "launches_forward": fwd_launches, "forward_ms_first_call": fwd_ms,
            "backward_ms_first_call": bwd_ms, "forward_ms_warm": fwd_warm,
            "fwd_bwd_ms_warm": fwd_bwd_warm, "peak_mem_gib": peak_gib,
            "scipy_max_abs_err": sci_err, "scipy_max_abs_c": scale,
            "plain_max_abs_err": fwd_err, "grad_max_abs_err": grad_err,
            "spmspm_n": SPMSPM_N, "spmspm_ms": mm_ms,
            "spmspm_scipy_max_abs_err": mm_err, "card": card}
    return {"spgemm": launches, "spmspm": mm_launches}, rows, line


def time_library(fn, flush):
    """The time of one library call, or why it could not run."""
    try:
        return time_ms(fn, max(3, REPS // 4), flush), None
    except RuntimeError as err:
        return None, str(err)[:200]


def spgemm_rows(a, plan, dense_b, spec, flush):
    """B5, B6, dB and B7 at the cage12 shapes, f32: each held against its
    plain version and timed after an L2 flush beside its bound, the plain
    version and, for B5 and B7, ``torch.sparse.mm`` (cuSPARSE)."""
    from repro_torch.core.formats import csr_to_ell
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_csr,
                                                 maple_sddmm_csr_plain)
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_db_plain,
                                                  maple_spgemm_numeric,
                                                  maple_spgemm_numeric_plain)
    from repro_torch.kernels.maple_spmspm import (maple_spmspm_ell,
                                                  maple_spmspm_ell_plain)
    dtype, isz = torch.float32, 4
    m, n = a.shape
    cap, nnz, p = plan.nnz_c, a.nnz, plan.stats.partial_products
    # plan bytes each kernel reads: row pointers (int32 / int64), per-slot
    # int32 arrays, part_ptr (int64), one int32 position per partial
    meta = {"a_rptr": 4 * (m + 1), "a_cols": 4 * nnz, "a_rows": 4 * nnz,
            "b_rptr": 4 * (n + 1), "part_ptr": 8 * (nnz + 1), "pos": 4 * p,
            "out_rptr": 8 * (m + 1), "t_ptr": 4 * (n + 1), "t_perm": 4 * nnz}
    fwd_meta = sum(meta[k] for k in ("a_rptr", "a_cols", "b_rptr",
                                     "part_ptr", "pos", "out_rptr"))
    db_meta = sum(meta[k] for k in ("a_rows", "part_ptr", "pos", "out_rptr",
                                    "b_rptr", "t_ptr", "t_perm"))
    crow = torch.from_numpy(a.row_ptr.astype(np.int64)).cuda()
    col = torch.from_numpy(a.col_id[:nnz].astype(np.int64)).cuda()
    a_sparse = torch.sparse_csr_tensor(crow, col, a.value[:nnz], a.shape)
    rng = np.random.default_rng(SEED + 10)
    dc = torch.from_numpy(rng.standard_normal(cap).astype(np.float32)).cuda()
    values, col_ids = csr_to_ell(a)
    shape = f"{CAGE12} C=A×A n={m} nnz={nnz} P={p} nnz_c={cap}"
    rows = []
    for name, kernel, plain, library, nbytes in (
            ("maple_spgemm_numeric",
             lambda: maple_spgemm_numeric(a.value, a.value, plan, cap=cap),
             lambda: maple_spgemm_numeric_plain(a.value, a.value, plan,
                                                cap=cap),
             lambda: torch.sparse.mm(a_sparse, a_sparse),
             nnz * isz + fwd_meta + cap * isz),      # A's values once
            ("maple_sddmm_csr",
             lambda: maple_sddmm_csr(dc, a.value, plan, n_slots=nnz),
             lambda: maple_sddmm_csr_plain(dc, a.value, plan, n_slots=nnz),
             None, (cap + nnz) * isz + fwd_meta + nnz * 4),
            ("maple_spgemm_db",
             lambda: maple_spgemm_db(dc, a.value, plan, n_slots=nnz),
             lambda: maple_spgemm_db_plain(dc, a.value, plan, n_slots=nnz),
             None, (cap + nnz) * isz + db_meta + nnz * 4)):
        rows.append(measure_sparse(
            name, kernel, plain, library, nbytes, 2 * p, dtype, spec, flush,
            shape=shape))
    # B7 reads every ELL column id (to find the pads) but only the live
    # values
    rows.append(measure_sparse(
        "maple_spmspm_ell", lambda: maple_spmspm_ell(values, col_ids, dense_b),
        lambda: maple_spmspm_ell_plain(values, col_ids, dense_b),
        lambda: torch.sparse.mm(a_sparse, dense_b),
        nnz * isz + col_ids.numel() * 4 + dense_b.numel() * isz
        + m * SPMSPM_N * isz,
        2 * nnz * SPMSPM_N, dtype, spec, flush,
        shape=f"{CAGE12} A (ELL {m}x{values.shape[1]}) x dense ({n}, "
        f"{SPMSPM_N})"))
    return rows


def measure_sparse(name, kernel, plain, library, nbytes, flops, dtype, spec,
                   flush, shape):
    """Check a kernel against its plain version, then time both, the
    library call (where one exists) and the bound."""
    got = kernel()
    torch.cuda.synchronize()
    err = check_close(got, plain(), dtype, f"{name} {shape}")
    del got
    lib_ms, lib_error = (time_library(library, flush) if library
                         else (None, "no single-call equivalent"))
    t_bytes, t_ops = nbytes / spec[0] * 1e3, flops / spec[1][dtype] * 1e3
    return {"name": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": shape, "max_abs_err": err,
            "ms": time_ms(kernel, REPS, flush),
            "plain_ms": time_ms(plain, max(3, REPS // 4), flush),
            "library_ms": lib_ms, "library_note": lib_error,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def profile(fn, warmup: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler (after one call outside it
    with ``warmup``): wall ms, the device time summed over kernels, the
    kernels that took the most of it, and the host operators with the
    most self time (inflated by the profiler's own cost)."""
    from torch.profiler import ProfilerActivity
    if warmup:
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
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "launches": sum(e.count for e in kernels),
            "top": [{"kernel": e.key[:80], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:8]],
            "host_top": [{"op": e.key[:60], "count": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3}
                         for e in host[:8]]}


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

    n_edge = edge_cases() + sddmm_edge_cases()
    emit({"phase": "kernels_edge", "cases": n_edge, "ok": True})
    rows, plan_s = serving_shapes(spec, flush)
    train_rows, train_plans = training_shapes(spec, flush)
    rows += train_rows
    for row in rows:
        emit({"phase": "kernels", "card": smi, **row})
    emit({"phase": "head_plan", "plan_spmm_s": plan_s,
          "train_plans": train_plans})
    del flush
    torch.cuda.empty_cache()

    emit(small_reference())
    serve_launches, serve_line = serve(smi)
    emit(serve_line)
    emit(train_reference())
    train_launches, train_line = train(smi)
    emit(train_line)
    emit(head_backward())
    emit(spgemm_kernels_edge())
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    spgemm_launches, spgemm_kernel_rows, spgemm_line = spgemm(spec, flush,
                                                              smi)
    emit(spgemm_line)
    for row in spgemm_kernel_rows:
        emit({"phase": "kernels", "card": smi, **row})
    rows += spgemm_kernel_rows

    # launches: each path's run, counted from 0
    by_path = {"serve": serve_launches, "train": train_launches,
               **spgemm_launches}
    f32 = lambda n: lambda r: r["dtype"] == "float32" and r.get("N") == n
    headline = {"maple_spmm_naive": f32(1), "maple_spmm_compact": f32(1),
                "maple_sddmm_bsr": f32(256),
                **{k: f32(None) for k in SPGEMM_COUNTERS}}
    keys = ("shape", "dtype", "G", "N", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")
    summary = []
    for kname, pick in headline.items():
        counts = {p: c[kname] for p, c in by_path.items() if kname in c}
        if not sum(counts.values()):
            raise AssertionError(f"{kname} was never launched on the main "
                                 f"path: {counts}")
        mine = [r for r in rows if r["name"] == kname]
        top = next(r for r in mine if pick(r))
        summary.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": sum(counts.values()),
            "launches_by_path": counts,
            **{k: top[k] for k in keys if k in top and k != "dtype"},
            "shapes": [{k: r[k] for k in keys if k in r} for r in mine]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if "PYTHONHASHSEED" not in os.environ:
        # sparsity.generate seeds its rng with hash() of the clone's name:
        # fix the string hashes so that every run plans the same cage12
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
