"""Dry run (port of ``repro.launch.dryrun``): every (architecture × input
shape) cell on the production meshes, walked on ``meta`` tensors, with
its memory, cost and collective evidence.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun

The reference lowers and compiles each cell's jitted step on 512 forced
host devices.  The port has no compiler to ask, so a cell is a walk
(``roofline.jaxpr_cost``) of the step on ``meta`` tensors under
``use_mesh_rules`` over a debug mesh of the production shape, ``(16,
16)`` or ``(2, 16, 16)``, whose every coordinate is the ``meta`` device
(``make_production_mesh`` would need 256 cards): the parameters from
``init_params(device="meta")`` in bf16, ``input_specs``, the optimizer
state with ``bf16_first_moment``; the step is ``train_step``, ``prefill``
or ``decode_step``.  The memory report reckons the per-device bytes from
the specs and the walk (``roofline.analysis.memory_report``); the
roofline takes the walk's FLOPs and bytes and the collectives of the
port's own mesh code (``"collectives_modelled": "port mesh code only"``).

Every layer group of a stack runs the same ops, and so does every
microbatch after the second, so the walk is made at two depths (``g1 <
g2`` groups, which keep the config's two-level remat) and, for a train
step of more than three microbatches, at two and three of them; every
count is then extended linearly to the full config, as the reference's
walker multiplies a scanned body by its trip count.  That is exact for
the FLOPs, the bytes and the op count; the peak of live bytes is
extended the same way (an approximation, like the temporaries
themselves).  ``report["walk"]`` says what was walked.

``lower_compile_s`` is ``trace_s``: the host seconds of the walks.
``fits_hbm`` compares the per-device total with the card's
``total_memory`` (80 GiB, the H100 80GB HBM3's, where no card is
visible).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Dict, List, Tuple

import torch

from repro_torch.configs import (ARCHS, SHAPES, get_config, input_specs,
                                 shape_applicable)
from repro_torch.distributed.sharding import (INFERENCE_RULES,
                                              PREFILL_SP_RULES,
                                              batch_shardings,
                                              leaves_with_path,
                                              param_shardings,
                                              state_shardings,
                                              use_mesh_rules)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.jaxpr_cost import Cost, jaxpr_cost
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

BF16 = torch.bfloat16
# NVIDIA H100 80GB HBM3: 80 GiB, where no card is visible to ask
HBM_DEFAULT = 80 * 2 ** 30


def hbm_per_chip() -> int:
    """The card's ``total_memory`` (what the smoke's ``device`` phase
    prints), else the H100 80GB HBM3's 80 GiB."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return HBM_DEFAULT


def production_mesh(multi_pod: bool):
    """The production topology's debug mesh on ``meta``: ``(data=16,
    model=16)``, or ``(pod=2, data=16, model=16)``."""
    if multi_pod:
        return make_debug_mesh((2, 16, 16), ("pod", "data", "model"),
                               device="meta")
    return make_debug_mesh((16, 16), ("data", "model"), device="meta")


# --------------------------------------------------------------------------
# the per-device bytes of a tree under its shardings
# --------------------------------------------------------------------------

def _sharded_leaves(tree, shardings) -> List[Tuple]:
    """``(shape, dtype size, spec, mesh shape)`` of every tensor leaf of
    ``tree`` beside its sharding (scalars and host arrays left out)."""
    shards = [leaf for _, leaf in leaves_with_path(shardings)]
    leaves = [leaf for _, leaf in leaves_with_path(tree)]
    return [(tuple(t.shape), t.element_size(), s.spec, s.mesh.shape)
            for t, s in zip(leaves, shards) if isinstance(t, torch.Tensor)]


# --------------------------------------------------------------------------
# the walk, at two depths (and microbatch counts), extended linearly
# --------------------------------------------------------------------------

def _groups_walked(cfg) -> Tuple[int, int]:
    """Two group counts ``g1 < g2`` that run the same remat structure as
    the config's ``n_groups`` (two-level where ``scan_remat_chunk``
    divides it), or ``(n_groups, n_groups)`` where it is that small."""
    _, n_groups, _ = cfg.layer_plan()
    chunk = cfg.scan_remat_chunk
    two_level = chunk > 1 and n_groups % chunk == 0
    fits = [g for g in range(1, n_groups + 1)
            if chunk <= 1 or (g % chunk == 0) == two_level]
    g1, g2 = fits[:2] if len(fits) >= 2 else (n_groups, n_groups)
    return (n_groups, n_groups) if n_groups <= g2 else (g1, g2)


def _with_groups(cfg, groups: int):
    unit, n_groups, tail = cfg.layer_plan()
    if groups == n_groups:
        return cfg
    return dataclasses.replace(cfg, n_layers=groups * len(unit) + len(tail))


_COUNTS = ("flops", "bytes", "dot_flops", "peak_bytes", "ops")


def _extend(costs: Dict[Tuple[int, int], Cost],
            full: Tuple[int, int]) -> Cost:
    """The bilinear extension of walks at ``(groups, microbatches)``
    points to ``full``: each count is ``a + b·g + c·m + d·g·m``, exact
    where every further group and microbatch adds the same ops."""
    gs = sorted({g for g, _ in costs})
    ms = sorted({m for _, m in costs})
    g1, g2 = gs[0], gs[-1]
    m1, m2 = ms[0], ms[-1]
    fg = (full[0] - g1) / (g2 - g1) if g2 != g1 else 0.0
    fm = (full[1] - m1) / (m2 - m1) if m2 != m1 else 0.0

    def value(get):
        c11, c21 = get(costs[g1, m1]), get(costs[g2, m1])
        c12, c22 = get(costs[g1, m2]), get(costs[g2, m2])
        return (c11 + fg * (c21 - c11) + fm * (c12 - c11)
                + fg * fm * (c22 - c21 - c12 + c11))

    out = Cost()
    for name in _COUNTS:
        setattr(out, name, value(lambda c: float(getattr(c, name))))
    out.ops = int(round(out.ops))
    kinds = {k for c in costs.values() for k in c.collectives}
    out.collectives = {k: value(lambda c: c.collectives.get(k, 0.0))
                       for k in sorted(kinds)}
    return out


def _input(spec: torch.Tensor, cfg, device, generator) -> torch.Tensor:
    """A batch leaf like ``spec`` (a ``meta`` stand-in) on ``device``:
    tokens drawn below the vocabulary, floats standard normal."""
    if device == "meta":
        return spec
    if spec.dtype.is_floating_point:
        return torch.randn(spec.shape, generator=generator, device=device
                           ).to(spec.dtype)
    return torch.randint(0, cfg.vocab_size, spec.shape, generator=generator,
                         device=device, dtype=spec.dtype)


def step_call(cfg, shape, ocfg, micro: int, *, device="meta",
              generator=None):
    """A zero-argument call of the cell's step for ``cfg`` on ``device``
    (bf16 parameters; ``meta`` with no generator): ``train_step`` over
    ``micro`` microbatches of the config's microbatch size, ``prefill``
    or ``decode_step``.  The same ops on every device, so a walk of it on
    ``meta`` counts what the same walk on the card does."""
    params = lm.init_params(cfg, generator, BF16, device=device)
    batch = {k: _input(v, cfg, device, generator)
             for k, v in input_specs(cfg, shape, dtype=BF16).items()}
    if shape.kind == "train":
        rows = shape.global_batch // cfg.train_microbatches * micro
        batch = {k: v[:rows] for k, v in batch.items()}
        params = lm.unstack_layers(params)
        opt = init_opt_state(ocfg, params)
        step = make_train_step(cfg, ocfg, micro_batches=micro)
        return lambda: step(params, opt, batch)
    if shape.kind == "prefill":
        return lambda: lm.prefill(params, cfg, batch, max_seq=shape.seq_len)
    state = lm.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                 dtype=BF16, device=device)
    return lambda: lm.decode_step(params, cfg, state, batch["tokens"])


def _walk_step(cfg, shape, ocfg, micro: int):
    """One walk of the cell's step for ``cfg`` (a depth of the full
    config) on ``meta``."""
    return jaxpr_cost(step_call(cfg, shape, ocfg, micro))


def walk_cell(cfg, shape, ocfg=None):
    """The cell's cost for the full ``cfg``, from walks at two depths
    (and, for a long microbatch loop, two microbatch counts); returns
    ``(cost, what was walked)``."""
    _, n_groups, _ = cfg.layer_plan()
    gs = sorted(set(_groups_walked(cfg)))
    n_micro = cfg.train_microbatches if shape.kind == "train" else 1
    ms = [n_micro] if n_micro <= 3 else [2, 3]
    costs = {}
    for g in gs:
        for m in ms:
            costs[g, m] = _walk_step(_with_groups(cfg, g), shape, ocfg, m)
    cost = _extend(costs, (n_groups, n_micro))
    return cost, {"groups": gs, "of_groups": n_groups, "microbatches": ms,
                  "of_microbatches": n_micro,
                  "ops_walked": sum(c.ops for c in costs.values())}


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------

def optimizer_config(cfg, opt_overrides=None) -> OptimizerConfig:
    """The train step's optimizer: bf16 first moments where the config
    asks for them, then ``opt_overrides``."""
    odefaults = {"m_dtype": BF16} if cfg.bf16_first_moment else {}
    odefaults.update(opt_overrides or {})
    return OptimizerConfig(**odefaults)


def cell_report(cfg, shape, mesh, rules=None, hbm=None,
                opt_overrides=None) -> Dict:
    """The memory and roofline report of the step ``shape`` asks for on
    ``cfg`` under ``mesh`` (its specs over ``mesh``'s axes; the walk is
    on ``meta`` whatever the mesh's devices): the report's keys from
    ``trace_s`` on."""
    t0 = time.time()
    params = lm.init_params(cfg, None, BF16, device="meta")
    ocfg = None
    with use_mesh_rules(mesh, rules):
        p_leaves = _sharded_leaves(params, param_shardings(params, mesh))
        batch = input_specs(cfg, shape, dtype=BF16)
        b_shard = batch_shardings(batch, mesh)
        args = p_leaves + _sharded_leaves(batch, b_shard)
        if shape.kind == "train":
            ocfg = optimizer_config(cfg, opt_overrides)
            opt = init_opt_state(ocfg, params)
            o_leaves = _sharded_leaves(opt, param_shardings(opt, mesh))
            args += o_leaves
            # the step donates the parameters and the optimizer state
            outs = alias = p_leaves + o_leaves
        else:
            state = lm.init_decode_state(cfg, shape.global_batch,
                                         shape.seq_len, dtype=BF16,
                                         device="meta")
            s_leaves = _sharded_leaves(state, state_shardings(state, mesh))
            logits = {"logits": torch.empty(
                (shape.global_batch, 1, cfg.vocab_padded), dtype=BF16,
                device="meta")}
            outs = (_sharded_leaves(logits, batch_shardings(logits, mesh))
                    + s_leaves)
            if shape.kind == "decode":
                args += s_leaves
                alias = s_leaves
            else:
                alias = []
        cost, walked = walk_cell(cfg, shape, ocfg)
    report = {"trace_s": round(time.time() - t0, 1), "walk": walked}

    batch_div = 1
    for entry in b_shard["tokens"].spec[:1]:
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            batch_div *= mesh.shape[ax]
    mem = roofline.memory_report(args, outs, cost.peak_bytes, batch_div,
                                 alias)
    hbm = hbm_per_chip() if hbm is None else hbm
    report["memory"] = mem
    report["hbm_per_chip_bytes"] = hbm
    report["fits_hbm"] = mem.get("total_hbm_bytes", 0) <= hbm
    report["hbm_gib_per_chip"] = round(
        mem.get("total_hbm_bytes", 0) / 2 ** 30, 2)

    rl = roofline.analyze(cost, mesh.size)
    active = cfg.param_count(active_only=True)
    mflops = roofline.model_flops(cfg, shape, active)
    report["roofline"] = rl.summary(model_flops_global=mflops)
    report["roofline"]["dot_flops"] = cost.dot_flops
    report["collectives_modelled"] = "port mesh code only"
    report["active_params"] = active
    report["total_params"] = cfg.param_count()
    return report


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_overrides=None, cfg_overrides=None, rules=None,
               hbm=None, config=None):
    """Walk one (arch × shape × mesh) cell; return the report dict.
    ``hbm``: the per-chip bytes ``fits_hbm`` compares with (default
    :func:`hbm_per_chip`); ``config``: a ``ModelConfig`` walked in place
    of ``get_config(arch)`` (a smoke config, say)."""
    cfg = get_config(arch) if config is None else config
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = production_mesh(multi_pod)
    report = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": mesh.size,
        "status": "ok",
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        report["status"] = "skipped"
        report["reason"] = why
        return report
    report.update(cell_report(cfg, shape, mesh, rules, hbm, opt_overrides))
    return report


def _parse_overrides(args) -> Dict:
    overrides = {}
    if args.moe_ep:
        overrides["moe_impl"] = "ep_a2a"
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v
    return overrides


RULES = {"default": None, "sp": PREFILL_SP_RULES, "infer": INFERENCE_RULES}


def _cell(arch, shape, multi, overrides, rules, hbm):
    """:func:`lower_cell`, a failure reported as ``"FAILED"`` with its
    error (a failure here is a fault of the port)."""
    try:
        return lower_cell(arch, shape, multi,
                          cfg_overrides=overrides or None,
                          rules=RULES[rules], hbm=hbm)
    except Exception as e:
        return {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if multi else "16x16",
                "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _line(rep) -> str:
    tag = (f"{rep['arch']}|{rep['shape']}|"
           f"{'multi' if rep['mesh'] == '2x16x16' else 'single'}")
    status = rep["status"]
    if status == "ok":
        r = rep["roofline"]
        extra = (f" hbm={rep['hbm_gib_per_chip']}GiB "
                 f"dom={r['dominant']} "
                 f"step={r['step_time_s']:.3e}s "
                 f"rf={r.get('roofline_fraction', 0):.3f} "
                 f"[{rep['trace_s']}s]")
    elif status == "skipped":
        extra = f" ({rep['reason'][:60]}...)"
    else:
        extra = f" {rep.get('error', '')[:120]}"
    return f"{tag:60s} {status}{extra}"


def run_grid(archs, shapes, meshes, overrides=None, rules="default",
             out_dir=None, log=print) -> List[Dict]:
    """Every cell of ``archs × shapes × meshes`` (``meshes``: a list of
    ``multi_pod`` flags; ``rules`` a key of :data:`RULES`), each reported
    by :func:`lower_cell` and logged as one line, in grid order.  Several
    cells are walked by as many processes as there are cores less one
    (spawned: a walk is host work and shares nothing).  A spawned worker
    re-imports the caller's main module: call this from under ``if
    __name__ == "__main__":``, as a spawning program must."""
    cells = [(arch, shape, multi) for arch in archs for shape in shapes
             for multi in meshes]
    workers = min(len(cells), max(1, (os.cpu_count() or 1) - 1))
    hbm = hbm_per_chip()
    args = [(a, sh, m, overrides, rules, hbm) for a, sh, m in cells]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=workers, mp_context=ctx) as pool:
            # the train cells (the longest walks) first, logged in order
            first = sorted(range(len(args)),
                           key=lambda i: SHAPES[args[i][1]].kind != "train")
            futures = {i: pool.submit(_cell, *args[i]) for i in first}
            reports = (futures[i].result() for i in range(len(args)))
            results = _logged(reports, out_dir, log)
    else:
        results = _logged((_cell(*a) for a in args), out_dir, log)
    return results


def _logged(reports, out_dir, log) -> List[Dict]:
    results = []
    for rep in reports:
        results.append(rep)
        log(_line(rep))
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            fn = (f"{rep['arch']}_{rep['shape']}_"
                  f"{'multi' if rep['mesh'] == '2x16x16' else 'single'}"
                  f".json")
            with open(os.path.join(out_dir, fn), "w") as f:
                json.dump(rep, f, indent=1, default=str)
    return results


def summary_line(results) -> str:
    n_fail = sum(r["status"] == "FAILED" for r in results)
    return (f"{len(results)} cells: "
            f"{sum(r['status'] == 'ok' for r in results)} ok, "
            f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
            f"{n_fail} FAILED")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output directory")
    ap.add_argument("--moe-ep", action="store_true",
                    help="use the all-to-all EP MoE path")
    ap.add_argument("--rules", choices=("default", "sp", "infer"),
                    default="default",
                    help="sp = weight-replicated sequence parallelism; "
                         "infer = model-only weight sharding (no FSDP)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (ints/floats/str)")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = run_grid(archs, shapes, meshes, _parse_overrides(args),
                       args.rules, args.out,
                       log=lambda s: print(s, flush=True))
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"\n{summary_line(results)}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
