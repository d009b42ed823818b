"""Paper reproduction tables: Fig. 8 (area), Fig. 9 (energy benefit %,
speedup %) over the 14 Table-I matrix clones (C = A×A protocol); port of
``benchmarks/paper_tables.py``.

Prints one CSV row per matrix (both families) plus the mean rows that
correspond to the paper's headline numbers, and the full assumption set
(energy table, area constants, bandwidths) so every figure is traceable.
The text is the reference bench's, line for line.  The clones are
generated on ``--device``; the model reads their metadata on the host.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.paper_tables --scale 0.05 \
      --device cpu
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core import analyze_spgemm, compare, sparsity
from repro_torch.core import energy as en
from repro_torch.core.dataflows import (extensor_baseline, extensor_maple,
                                        matraptor_baseline, matraptor_maple)

PAPER = {"matraptor": {"energy": 50.0, "speedup": 15.0, "area": 5.9},
         "extensor": {"energy": 60.0, "speedup": 22.0, "area": 15.5}}


def run(scale: float = 0.05, seed: int = 0, csv: bool = True,
        device="cuda"):
    """One row per Table-I clone: its statistics, the two families'
    :class:`~repro_torch.core.dataflows.Comparison`, and the host seconds
    of its generation (``generate_s``) and of the model (``analyze_s``:
    ``analyze_spgemm`` and both ``compare`` calls)."""
    rows = []
    for ab, spec in sparsity.TABLE_I.items():
        t0 = time.perf_counter()
        a = sparsity.generate(spec, scale=scale, seed=seed, device=device)
        t1 = time.perf_counter()
        st = analyze_spgemm(a)
        res = {"matrix": ab, "n": st.n_rows, "nnz": st.nnz_a,
               "P": st.partial_products, "nnz_C": st.nnz_c,
               "generate_s": t1 - t0}
        for fam in ("matraptor", "extensor"):
            res[fam] = compare(fam, st)
        res["analyze_s"] = time.perf_counter() - t1
        rows.append(res)

    if csv:
        print("# paper_tables: Fig.8/Fig.9 reproduction "
              f"(Table-I clones @ scale={scale})")
        print("matrix,n,nnz,P,nnzC,"
              "MR_energy_pct,MR_onchip_pct,MR_speedup_pct,MR_area_x,"
              "EX_energy_pct,EX_onchip_pct,EX_speedup_pct,EX_area_x")
        for r in rows:
            mr, ex = r["matraptor"], r["extensor"]
            print(f"{r['matrix']},{r['n']},{r['nnz']},{r['P']},{r['nnz_C']},"
                  f"{mr.energy_benefit_pct:.1f},"
                  f"{mr.onchip_energy_benefit_pct:.1f},"
                  f"{mr.speedup_pct:.1f},{mr.area_ratio:.1f},"
                  f"{ex.energy_benefit_pct:.1f},"
                  f"{ex.onchip_energy_benefit_pct:.1f},"
                  f"{ex.speedup_pct:.1f},{ex.area_ratio:.1f}")

        for fam, tag in (("matraptor", "MR"), ("extensor", "EX")):
            e, oc, sp, ar = means(rows, fam)
            p = PAPER[fam]
            print(f"MEAN_{tag},,,,,{e:.1f},{oc:.1f},{sp:.1f},{ar:.1f}  "
                  f"# paper: energy={p['energy']}% speedup={p['speedup']}% "
                  f"area={p['area']}x")

        print("\n# assumptions (normalized energy/access, Fig. 3 ordering):")
        print("#", en.ENERGY_PER_EVENT)
        for mk in (matraptor_baseline, matraptor_maple, extensor_baseline,
                   extensor_maple):
            c = mk()
            print(f"# {c.name}: PEs={c.n_pes}×{c.macs_per_pe}MAC "
                  f"q={c.queue_kb}KB peb={c.pe_buffer_kb}KB "
                  f"llb={c.llb_mb}MB dram={c.dram_wpc}w/c")
    return rows


def means(rows, fam: str):
    """The mean row of one family: energy, on-chip energy and speedup %
    averaged over the clones, and the (workload-independent) area ratio."""
    mean = lambda xs: sum(xs) / len(xs)
    return (mean([r[fam].energy_benefit_pct for r in rows]),
            mean([r[fam].onchip_energy_benefit_pct for r in rows]),
            mean([r[fam].speedup_pct for r in rows]),
            rows[0][fam].area_ratio)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05,
                    help="Table-I clone scale (1.0 = full dimensions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(scale=args.scale, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
