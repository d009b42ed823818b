"""Accelerator simulation: the paper's full §IV evaluation at an
arbitrary clone scale, with per-matrix event traces (port of
``examples/accelerator_sim.py``).  The clones are generated on
``--device``; the event model reads their metadata on the host.

Run:  PYTHONPATH=src python -m repro_torch.examples.accelerator_sim \
          --scale 0.1 --matrices wg sc fb [--spgemm] [--events] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import analyze_spgemm, compare, simulate, sparsity
from repro_torch.core.dataflows import matraptor_baseline, matraptor_maple
from repro_torch.examples import say


def spgemm_kernel_sweep(n: int = 64, n_lanes: int = 8, device="cuda",
                        lines=None) -> list:
    """Bridge the event model and the executable kernel.

    Runs the paper's C = A·A protocol on uniform / power-law / banded
    patterns through the two-phase sparse-output SpGEMM pipeline
    (``plan_spgemm`` symbolic phase + ``maple_spgemm`` numeric kernel, B5
    on the card), prices each plan with the shared ``core.maple`` cycle
    model, and pins the kernel to ``gustavson.spmspm_rowwise`` and the
    dense oracle.  Returns one row a pattern: the plan's statistics and
    cycles, C densified on the host and the largest error (``err``)."""
    from repro_torch.core.csr import CSR
    from repro_torch.core.gustavson import dense_oracle, spmspm_rowwise
    from repro_torch.kernels import maple_spgemm, plan_spgemm

    dev = resolve_device(device)
    lines = [] if lines is None else lines
    rng = np.random.default_rng(0)
    say(lines, f"\n=== sparse-output SpGEMM kernel sweep (C = A·A, n={n}) ===")
    rows = []
    for kind in ("uniform", "power_law", "banded"):
        mask = sparsity.element_pattern_mask(kind, rng, n, n)
        d = (mask * rng.standard_normal((n, n))).astype(np.float32)
        a = CSR.from_dense(d, device=dev)
        plan = plan_spgemm(a, a, n_lanes=n_lanes)
        c = maple_spgemm(a, a, plan=plan)
        cd = c.to_dense()
        err = max(float((cd - dense_oracle(a, a)).abs().max()),
                  float((cd - spmspm_rowwise(a, a)).abs().max()))
        pc = plan.predicted_cycles()
        st = plan.stats
        say(lines, f"  {kind:10s} nnz(A)={st.nnz_a:5d} "
                   f"P={st.partial_products:6d} "
                   f"nnz(C)={plan.nnz_c:5d} cycles plan={pc['plan']:.0f} "
                   f"maple={pc['maple']:.0f} "
                   f"row_atomic={pc['row_atomic']:.0f} max|dC|={err:.1e}")
        rows.append({"kind": kind, "stats": st, "nnz_c": plan.nnz_c,
                     "cycles": pc, "c": cd.cpu(), "err": err})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--matrices", nargs="*",
                    default=["wg", "sc", "fb"])
    ap.add_argument("--events", action="store_true",
                    help="print the raw event trace per config")
    ap.add_argument("--spgemm", action="store_true",
                    help="also run the executable sparse-output SpGEMM "
                         "kernel sweep against the torch oracles")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    lines = []
    out = {"lines": lines, "sweep": None, "matrices": {}}
    if args.spgemm:
        out["sweep"] = spgemm_kernel_sweep(device=args.device, lines=lines)

    for ab in args.matrices:
        spec = sparsity.TABLE_I[ab]
        a = sparsity.generate(spec, scale=args.scale, device=args.device)
        st = analyze_spgemm(a)
        say(lines, f"\n=== {spec.name} ({ab}) × itself, "
                   f"scale={args.scale} ===")
        say(lines, f"  n={st.n_rows:,} nnz={st.nnz_a:,} "
                   f"P={st.partial_products:,} nnz(C)={st.nnz_c:,} "
                   f"compaction={st.compaction:.2f}")
        comparisons = {}
        for fam in ("matraptor", "extensor"):
            c = comparisons[fam] = compare(fam, st)
            say(lines, f"  {fam:10s} energy {c.energy_benefit_pct:5.1f}% "
                       f"(on-chip {c.onchip_energy_benefit_pct:5.1f}%) "
                       f"speedup {c.speedup_pct:6.1f}% "
                       f"area {c.area_ratio:.1f}× "
                       f"bottleneck {c.baseline.bottleneck}→"
                       f"{c.maple.bottleneck}")
        events = {}
        if args.events:
            for mk in (matraptor_baseline, matraptor_maple):
                r = simulate(mk(), st)
                events[r.config.name] = r.events
                say(lines, f"  {r.config.name} events:")
                for k, v in r.events.items():
                    if v:
                        say(lines, f"    {k:14s} {v:,.0f}")
        out["matrices"][ab] = {"stats": st, "compare": comparisons,
                               "events": events}
    return out


if __name__ == "__main__":
    main()
