"""Schedule autotuner: search the SpMM plan knob space, cache per-pattern
plans (port of ``repro.kernels.autotune``).

A successive halving over :func:`~repro_torch.kernels.schedule
.spmm_knob_space`: (1) a free analytic makespan bound ranks the whole
enumeration and keeps ``budget`` configs, the hand-tuned default always
among them; (2) the survivors are built and ranked by the deterministic
surrogate (predicted cycles and the layout's output traffic); (3) with
``measure=True`` the ``top_k`` finalists run through ``maple_spmm`` on a
seeded right-hand side, timed round-robin, and the fastest wins.  The
third rung is where the two fused layouts, rmw (B4) and compact (B1 and
the slot merge), meet on the hardware.

The reference's three guarantees hold: never worse than the default
config under the surrogate, deterministic for one pattern, seed and
parameter set, and memoized per pattern fingerprint (a hit returns the
same plan object).  The shard axis is searched as in the reference:
shard counts come from the bound mesh (``distributed.sharding``) or the
caller, and a partitioned winner is a ``PartitionedSpmmPlan``.

``python -m repro_torch.kernels.autotune --smoke`` runs the surrogate-only
searches over the golden patterns on the CPU and checks those guarantees.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.csr import BlockCSR
from repro_torch.core.formats import as_block_csr
from repro_torch.distributed.sharding import (COL_AXIS, PARTITION_AXIS,
                                              active_mesh)
from repro_torch.kernels.partition import (PartitionedSpmmPlan,
                                           plan_partitioned_spmm,
                                           plan_partitioned_spmm_vjp)
from repro_torch.kernels.reorder import (occupancy_digest, pattern_standin,
                                         plan_reordered_spmm, reorder_rows)
from repro_torch.kernels.schedule import (SpmmTrainPlan,
                                          _default_chunk, pattern_fingerprint,
                                          plan_spmm, plan_spmm_vjp,
                                          spmm_knob_space)

DEFAULT_BUDGET = 32

# the hand-tuned defaults every caller gets without the autotuner: the
# config the search must never lose to (always built, always scored)
DEFAULT_CONFIG: Dict = dict(n_lanes=8, chunk=None, row_atomic=False,
                            fused="rmw", n_shards=1, n_col_shards=1,
                            device_chunk=None, reorder=False)

OBJECTIVES = ("cycles", "traffic", "us")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_interleaved(fns: Dict, args: Dict, reps: int = 8) -> Dict[str, float]:
    """Best-of-``reps`` µs of each variant, measured round-robin so that
    a slow window hits every variant alike.  Every variant runs once
    first; on the card each timed call is bracketed by
    ``torch.cuda.synchronize()``."""
    for name, fn in fns.items():
        fn(*args[name])
    _sync()
    best = {name: float("inf") for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            _sync()
            t0 = time.perf_counter()
            fn(*args[name])
            _sync()
            best[name] = min(best[name], time.perf_counter() - t0)
    return {name: b * 1e6 for name, b in best.items()}


# --------------------------------------------------------------------------
# surrogate: predicted cycles + output traffic, optionally calibrated to µs
# --------------------------------------------------------------------------

def plan_traffic_bytes(plan, *, g: int = 1, n_cols: int = 128) -> int:
    """Output-side HBM bytes of the plan's own layout (the reference's
    model): a partitioned plan sums its shards' compact layouts."""
    if isinstance(plan, PartitionedSpmmPlan):
        return sum(p.output_traffic_bytes(g, n_cols, mode="compact")
                   for p in plan.shards)
    return plan.output_traffic_bytes(g, n_cols)


def surrogate_cost(plan, *, objective: str = "cycles",
                   n_cols: int = 128,
                   calibration: Optional[Dict] = None) -> Tuple[float, float]:
    """Deterministic ``(primary, secondary)`` cost of a built plan:
    ``cycles`` ranks by the realized lane makespan then traffic,
    ``traffic`` the other way round, ``us`` by the calibration fit's
    affine map of cycles (needs ``calibration``)."""
    pred = float(plan.predicted_cycles()["plan"])
    traffic = float(plan_traffic_bytes(plan, n_cols=n_cols))
    if objective == "cycles":
        return (pred, traffic)
    if objective == "traffic":
        return (traffic, pred)
    if objective == "us":
        if calibration is None:
            raise ValueError(
                "objective='us' needs a calibration fit — pass "
                "calibration=load_calibration(path) (a bench file's "
                "'calibration' entry)")
        return (calibrated_us(pred, calibration), traffic)
    raise ValueError(f"unknown objective {objective!r}; one of {OBJECTIVES}")


def _prescore(row_lens: np.ndarray, cfg: Dict) -> float:
    """Rung-1 makespan lower bound, no plan built: the larger of the
    balanced share and the heaviest unsplittable item (a whole row when
    row-atomic, else one chunk)."""
    nnzb = int(row_lens.sum())
    if nnzb == 0:
        return 1.0
    shards, lanes = int(cfg["n_shards"]), int(cfg["n_lanes"])
    max_len = int(row_lens.max())
    if cfg["row_atomic"]:
        item = max_len
        if cfg["device_chunk"] is not None:
            item = min(item, int(cfg["device_chunk"]))
    else:
        per_shard = -(-nnzb // shards)
        chunk = cfg["chunk"] if cfg["chunk"] else _default_chunk(
            per_shard, lanes)
        item = min(int(chunk), max_len)
    return float(max(-(-nnzb // (shards * lanes)), item))


def build_plan(a, cfg: Dict, rr=None):
    """Materialize one knob config into its plan, single-device or
    partitioned as its ``n_shards`` / ``n_col_shards`` say; reorder
    configs plan on the permuted pattern and carry their ``RowReorder``
    (pass ``rr`` to share one similarity pass)."""
    col = int(cfg.get("n_col_shards", 1))
    if cfg.get("reorder"):
        if int(cfg["n_shards"]) > 1 or col > 1:
            raise ValueError(
                "reorder is a single-device knob (spmm_knob_space never "
                "pairs it with shard counts)")
        return plan_reordered_spmm(
            a, rr, n_lanes=int(cfg["n_lanes"]), chunk=cfg["chunk"],
            row_atomic=bool(cfg["row_atomic"]), fused=cfg["fused"])
    if int(cfg["n_shards"]) > 1 or col > 1:
        return plan_partitioned_spmm(
            as_block_csr(a), n_shards=int(cfg["n_shards"]),
            n_lanes=int(cfg["n_lanes"]), chunk=cfg["chunk"],
            device_chunk=cfg["device_chunk"],
            row_atomic=bool(cfg["row_atomic"]), n_col_shards=col)
    return plan_spmm(a, n_lanes=int(cfg["n_lanes"]), chunk=cfg["chunk"],
                     row_atomic=bool(cfg["row_atomic"]), fused=cfg["fused"])


# --------------------------------------------------------------------------
# the search
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchReport:
    """What one ``plan_search`` did — enough to audit the decision."""

    fingerprint: str
    objective: str
    budget: int
    n_candidates: int          # rung-1 enumeration size
    n_built: int               # rung-2 plans actually constructed
    best_config: Dict
    best_score: Tuple[float, float]
    default_score: Tuple[float, float]
    measured_us: Optional[Dict[int, float]]  # rung-3 finalist µs (or None)
    cache_hit: bool


@dataclasses.dataclass(frozen=True)
class _CacheEntry:
    plan: object
    config: Dict
    report: SearchReport


_PLAN_CACHE: Dict[Tuple, _CacheEntry] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    _CACHE_STATS["hits"] = _CACHE_STATS["misses"] = 0


def plan_cache_stats() -> Dict[str, int]:
    return dict(_CACHE_STATS, size=len(_PLAN_CACHE))


def _mesh_shard_counts() -> Tuple[int, ...]:
    """Shard counts worth searching: 1, plus the bound mesh's
    ``PARTITION_AXIS`` extent where a bound mesh reserves one."""
    mesh = active_mesh()
    if mesh is not None and mesh.shape.get(PARTITION_AXIS, 1) > 1:
        return (1, int(mesh.shape[PARTITION_AXIS]))
    return (1,)


def _mesh_col_shard_counts() -> Tuple[int, ...]:
    """The column split to pin: the bound mesh's ``COL_AXIS`` extent, else
    1 (a memory layout, never searched: the cycle model does not see
    it)."""
    mesh = active_mesh()
    if mesh is not None and mesh.shape.get(COL_AXIS, 1) > 1:
        return (int(mesh.shape[COL_AXIS]),)
    return (1,)


def _default_config_for(shard_counts: Sequence[int],
                        col_shard_counts: Sequence[int] = (1,)) -> Dict:
    """The hand-tuned baseline inside this search's space: the plain
    defaults where single-device is searched, else the defaults on the
    smallest shard count, compact, at the pinned column split."""
    cfg = dict(DEFAULT_CONFIG)
    if 1 not in shard_counts:
        cfg["n_shards"] = int(min(shard_counts))
        cfg["fused"] = "compact"
        cfg["n_col_shards"] = int(min(col_shard_counts))
    return cfg


def _same_config(x: Dict, y: Dict) -> bool:
    return all(x[k] == y[k] for k in DEFAULT_CONFIG)


def plan_search(a, *, objective: str = "cycles",
                budget: int = DEFAULT_BUDGET, n_lanes_max: int = 16,
                shard_counts: Optional[Sequence[int]] = None,
                col_shard_counts: Optional[Sequence[int]] = None,
                reorder: bool | str = False,
                measure: bool = False, top_k: int = 3, reps: int = 4,
                n_cols: int = 128, seed: int = 0,
                calibration: Optional[Dict] = None,
                use_cache: bool = True, full: bool = False):
    """Successive halving over the SpMM schedule knob space (module
    docstring), the reference's rungs, ties and cache key.

    ``reorder``: ``"auto"`` searches reordered and unreordered schedules
    side by side, ``True`` only reordered ones; reordered candidates are
    prescored on the permuted row lengths and the cache key then carries
    the payload's occupancy digest.  ``measure=True`` times the ``top_k``
    finalists through ``maple_spmm`` on a seeded ``(K, n_cols)``
    right-hand side on the operand's device.  ``full=True`` returns
    ``(plan, SearchReport)``.
    """
    if budget < 1:
        raise ValueError(f"budget={budget} < 1")
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {OBJECTIVES}")
    if shard_counts is None:
        shard_counts = _mesh_shard_counts()
    shard_counts = tuple(int(s) for s in shard_counts)
    if col_shard_counts is None:
        col_shard_counts = _mesh_col_shard_counts()
    col_shard_counts = tuple(int(s) for s in col_shard_counts)
    if reorder not in (False, True, "auto"):
        raise ValueError(f"reorder must be False, True or 'auto', "
                         f"got {reorder!r}")

    key = (pattern_fingerprint(a), "fwd", objective, int(budget),
           int(n_lanes_max), shard_counts, col_shard_counts, bool(measure),
           int(top_k), int(n_cols), int(seed), str(reorder))
    if reorder is not False:
        key = key + (occupancy_digest(a),)
    if use_cache and key in _PLAN_CACHE:
        _CACHE_STATS["hits"] += 1
        hit = _PLAN_CACHE[key]
        report = dataclasses.replace(hit.report, cache_hit=True)
        return (hit.plan, report) if full else hit.plan
    _CACHE_STATS["misses"] += 1

    # ---- rung 1: free analytic prescore over the full enumeration ----
    cfgs = spmm_knob_space(a, n_lanes_max=n_lanes_max,
                           shard_counts=shard_counts,
                           col_shard_counts=col_shard_counts,
                           reorder=reorder)
    default_cfg = _default_config_for(shard_counts, col_shard_counts)
    row_lens = np.diff(np.asarray(as_block_csr(a).row_ptr).astype(np.int64))
    rr = None
    row_lens_r = row_lens
    if any(c.get("reorder") for c in cfgs):
        rr = reorder_rows(a)
        row_lens_r = np.diff(np.asarray(rr.row_ptr).astype(np.int64))
    rng = np.random.default_rng(seed)
    jitter = rng.random(len(cfgs))  # deterministic tie-break within a rung
    ranked = sorted(range(len(cfgs)),
                    key=lambda i: (_prescore(
                        row_lens_r if cfgs[i].get("reorder") else row_lens,
                        cfgs[i]), jitter[i]))
    survivors = ranked[:budget]
    if not any(_same_config(cfgs[i], default_cfg) for i in survivors):
        # never worse: the baseline is always built and scored
        survivors = survivors[:max(budget - 1, 0)]
        survivors.append(next(
            (i for i in range(len(cfgs))
             if _same_config(cfgs[i], default_cfg)), None))
        if survivors[-1] is None:  # default outside the space: add it
            cfgs.append(default_cfg)
            survivors[-1] = len(cfgs) - 1

    # ---- rung 2: build + surrogate-score the survivors ----
    scored: List[Tuple[Tuple[float, float], int, object]] = []
    default_score = None
    for i in survivors:
        plan = build_plan(a, cfgs[i], rr=rr)
        s = surrogate_cost(plan, objective=objective, n_cols=n_cols,
                           calibration=calibration)
        scored.append((s, i, plan))
        if _same_config(cfgs[i], default_cfg):
            default_score = s
    scored.sort(key=lambda t: (t[0], t[1]))  # enum order breaks exact ties

    # ---- rung 3 (optional): measure the finalists, pick by wall clock ----
    measured_us = None
    best_score, best_i, best_plan = scored[0]
    if measure and len(scored) > 1:
        finalists = scored[:max(top_k, 1)]
        measured_us = _measure_finalists(
            a, [(i, p) for (_, i, p) in finalists], n_cols=n_cols,
            seed=seed, reps=reps)
        best_i = min(measured_us, key=lambda i: (measured_us[i], i))
        best_score, best_plan = next(
            (s, p) for (s, i, p) in finalists if i == best_i)

    report = SearchReport(
        fingerprint=key[0], objective=objective, budget=budget,
        n_candidates=len(cfgs), n_built=len(scored),
        best_config=dict(cfgs[best_i]), best_score=best_score,
        default_score=default_score, measured_us=measured_us,
        cache_hit=False)
    if use_cache:
        _PLAN_CACHE[key] = _CacheEntry(plan=best_plan,
                                       config=dict(cfgs[best_i]),
                                       report=report)
    return (best_plan, report) if full else best_plan


def _measure_finalists(a, finalists: List[Tuple[int, object]], *,
                       n_cols: int, seed: int,
                       reps: int) -> Dict[int, float]:
    """Rung 3: each finalist through ``maple_spmm`` (forward only) on a
    seeded right-hand side in the payload's type and device, timed with
    :func:`time_interleaved`."""
    from repro_torch.kernels.ops import maple_spmm  # ops imports this module

    blocks = as_block_csr(a).blocks
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.standard_normal((a.shape[1], n_cols))
                         .astype(np.float32)).to(blocks.device, blocks.dtype)
    fns = {i: (lambda bb, p=plan: maple_spmm(a, bb, plan=p))
           for i, plan in finalists}
    with torch.no_grad():
        return time_interleaved(fns, {i: (b,) for i, _ in finalists},
                                reps=reps)


def plan_search_vjp(a, **kw) -> SpmmTrainPlan:
    """``plan_search`` for trainable call sites: the searched forward plan
    plus the transpose-side plan built with the winning knobs (on the
    permuted pattern for a reordered winner).  Cached separately from the
    forward entry."""
    full = kw.pop("full", False)
    use_cache = kw.get("use_cache", True)
    fwd_plan, report = plan_search(a, **dict(kw, full=True))
    cfg = report.best_config
    key = ("train", report.fingerprint, report.objective,
           tuple(sorted((k, str(v)) for k, v in cfg.items())))
    if cfg.get("reorder"):
        key = key + (occupancy_digest(a),)
    if use_cache and key in _PLAN_CACHE:
        _CACHE_STATS["hits"] += 1
        hit = _PLAN_CACHE[key]
        rep = dataclasses.replace(hit.report, cache_hit=True)
        return (hit.plan, rep) if full else hit.plan
    if int(cfg["n_shards"]) > 1 or int(cfg.get("n_col_shards", 1)) > 1:
        tp = plan_partitioned_spmm_vjp(
            as_block_csr(a), n_shards=int(cfg["n_shards"]),
            n_lanes=int(cfg["n_lanes"]), chunk=cfg["chunk"],
            device_chunk=cfg["device_chunk"],
            row_atomic=bool(cfg["row_atomic"]),
            n_col_shards=int(cfg.get("n_col_shards", 1)), fwd=fwd_plan)
    else:
        base = pattern_standin(fwd_plan.reorder) if cfg.get("reorder") \
            else a
        tp = plan_spmm_vjp(as_block_csr(base), n_lanes=int(cfg["n_lanes"]),
                           chunk=cfg["chunk"],
                           row_atomic=bool(cfg["row_atomic"]),
                           fused=cfg["fused"], fwd=fwd_plan)
    if use_cache:
        _PLAN_CACHE[key] = _CacheEntry(plan=tp, config=dict(cfg),
                                       report=report)
    return (tp, report) if full else tp


def auto_plan(a, *, trainable: bool = False,
              n_shards: Optional[int] = None,
              n_col_shards: Optional[int] = None,
              objective: str = "cycles", budget: int = DEFAULT_BUDGET, **kw):
    """The ``plan="auto"`` entry point of ``maple_spmm``, the sparse
    layers and the serving head.  ``n_shards`` bounds the searched device
    axis and ``n_col_shards`` pins the column split, as in the reference;
    ``None`` reads both from the bound mesh.  ``trainable=True`` returns an
    :class:`~repro_torch.kernels.schedule.SpmmTrainPlan`."""
    if n_shards is not None:
        kw["shard_counts"] = (1, int(n_shards)) if n_shards > 1 else (1,)
    if n_col_shards is not None:
        kw["col_shard_counts"] = (int(n_col_shards),)
    search = plan_search_vjp if trainable else plan_search
    return search(a, objective=objective, budget=budget, **kw)


# --------------------------------------------------------------------------
# calibration: predicted cycles -> measured µs (per backend, affine)
# --------------------------------------------------------------------------

def fit_calibration(records: Sequence[Dict], *,
                    backend: str = "cpu") -> Optional[Dict]:
    """Least-squares affine fit ``us ≈ us_per_cycle · pred_plan +
    us_base`` over bench records carrying both, with the Spearman rank
    correlation of the two; ``None`` below 4 usable points."""
    pts = [(float(r["pred_plan"]), float(r["us_per_call"]))
           for r in records
           if isinstance(r, dict) and r.get("pred_plan")
           and r.get("us_per_call")]
    if len(pts) < 4:
        return None
    x = np.asarray([p for p, _ in pts])
    y = np.asarray([u for _, u in pts])
    slope, base = np.polyfit(x, y, 1)
    resid = y - (slope * x + base)
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - float((resid ** 2).sum()) / ss_tot if ss_tot > 0 else 1.0
    rx = np.argsort(np.argsort(x)).astype(np.float64)
    ry = np.argsort(np.argsort(y)).astype(np.float64)
    denom = float(np.sqrt(((rx - rx.mean()) ** 2).sum()
                          * ((ry - ry.mean()) ** 2).sum()))
    rank_corr = (float(((rx - rx.mean()) * (ry - ry.mean())).sum()) / denom
                 if denom > 0 else 1.0)
    return {"backend": backend, "us_per_cycle": float(slope),
            "us_base": float(base), "r2": round(r2, 4),
            "rank_corr": round(rank_corr, 4), "n_points": len(pts)}


def load_calibration(path: str) -> Optional[Dict]:
    """The ``calibration`` entry of a bench file, or ``None``."""
    with open(path) as f:
        payload = json.load(f)
    return payload.get("calibration")


def calibrated_us(pred_cycles: float, calibration: Dict) -> float:
    """The affine fit, clamped at zero (an extrapolation below the
    smallest workload must not go negative and flip an ordering)."""
    return max(calibration["us_per_cycle"] * float(pred_cycles)
               + calibration["us_base"], 0.0)


# --------------------------------------------------------------------------
# smoke: budgeted surrogate-only searches over the golden patterns
# --------------------------------------------------------------------------

def _plans_bit_identical(x, y) -> bool:
    """Array-field equality of two plans (train plans: both sides and
    the transpose gather)."""
    if type(x) is not type(y):
        return False
    if isinstance(x, SpmmTrainPlan):
        return (_plans_bit_identical(x.fwd, y.fwd)
                and _plans_bit_identical(x.bwd, y.bwd)
                and np.array_equal(x.t_perm, y.t_perm))
    fields = ("order", "step_row", "step_col", "written", "flush_slot",
              "slot_row")
    if isinstance(x, PartitionedSpmmPlan):
        if x.n_col_shards != y.n_col_shards:
            return False
        # a stacked plan keeps no written map of its own (its shards do)
        fields = ("order", "step_row", "step_col", "flush_slot", "slot_row",
                  "gather", "gather_live", "row_shard")
    return all(np.array_equal(getattr(x, f), getattr(y, f)) for f in fields)


def _smoke(budget: int = 24, seed: int = 0) -> int:
    """For each golden pattern kind: the searched plan's predicted cycles
    must not exceed the default plan's, a second search must hit the
    cache with the same object, and a search after a clear must give the
    same arrays."""
    from repro_torch.core.sparsity import block_pattern_mask

    failures = 0
    for kind in ("uniform", "power_law", "banded"):
        rng = np.random.default_rng(seed)
        gm, gk, bm, bk = 12, 12, 8, 8
        mask = block_pattern_mask(kind, rng, gm, gk)
        dense = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
        dense *= np.repeat(np.repeat(mask, bm, axis=0), bk, axis=1)
        a = BlockCSR.from_dense(dense, (bm, bk), device="cpu")

        pred_default = plan_spmm(a).predicted_cycles()["plan"]
        plan_cache_clear()
        p1, rep = plan_search(a, budget=budget, seed=seed, full=True)
        p2 = plan_search(a, budget=budget, seed=seed)
        plan_cache_clear()
        p3 = plan_search(a, budget=budget, seed=seed)
        pred_auto = p1.predicted_cycles()["plan"]

        ok = (pred_auto <= pred_default and p2 is p1
              and _plans_bit_identical(p1, p3))
        failures += not ok
        print(f"autotune-smoke,{kind},{'ok' if ok else 'FAIL'},"
              f"pred_default={pred_default:.0f},pred_auto={pred_auto:.0f},"
              f"built={rep.n_built}/{rep.n_candidates},"
              f"cfg={rep.best_config}")
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="budgeted surrogate-only searches on the golden "
                         "patterns")
    ap.add_argument("--budget", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(budget=args.budget, seed=args.seed)
    ap.error("nothing to do (pass --smoke)")
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
