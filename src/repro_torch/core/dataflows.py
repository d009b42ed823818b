"""The four accelerator configurations of the paper's §IV as event models.

Each configuration is an :class:`AccelConfig` whose :func:`simulate` walks the
metadata-exact workload statistics (``maple.analyze_spgemm``) and produces

* an :class:`~repro_torch.core.maple.EventCounts` trace (for the energy model),
* a cycle count from a Sparseloop-style *max-over-components* bandwidth model,
* a per-PE / array area split (for Fig. 8).

Configurations (paper §IV.B, iso-MAC within each pair):

===============  =====================================  =======================
                 baseline                               Maple-based
===============  =====================================  =======================
Matraptor        8 PEs × 1 MAC, SpAL/SpBL (L1) +        4 PEs × 2 MACs, ONE
                 per-PE sorting queues (L0); sort-       memory level: ARB/BRB/
                 merge accumulate, spills extra          PSB inside the PE; PSB
                 merge rounds through DRAM               accumulates in place
Extensor         128 PEs × 1 MAC (16×8), LLB+POB (L1),   8 PEs × 16 MACs, LLB
                 PEB (L0); partial outputs round-trip    (L1) only; final sums
                 through POB (and DRAM when the          inside the PE, POB
                 K-tiling overflows the LLB)             eliminated
===============  =====================================  =======================

Traffic formulas are derived from the row-wise product structure (see module
docstring of ``maple.py`` for the P / nnz_c definitions) and are printed by
``repro_torch.launch.paper_tables`` so every number of Fig. 8 / Fig. 9 is
traceable to a formula here.

Port of ``repro.core.dataflows``: host numpy over the statistics, the
same arithmetic in the same order, so every event count, cycle count,
energy and area equals the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import energy as en
from repro_torch.core.maple import (
    EventCounts,
    SpGEMMStats,
    baseline_pe_cycles,
    maple_pe_cycles,
    matraptor_merge_passes,
)

WORD_BYTES = 4  # fp32 values / int32 coordinates — one "word"


@dataclasses.dataclass(frozen=True)
class AccelConfig:
    name: str
    family: str                 # "matraptor" | "extensor"
    variant: str                # "baseline" | "maple"
    n_pes: int
    macs_per_pe: int

    # memory system
    has_l1: bool                # SpAL/SpBL or LLB present
    llb_mb: float = 0.0         # Extensor last-level buffer capacity
    has_pob: bool = False       # Extensor partial-output buffer
    n_queues: int = 0           # Matraptor sorting queues per PE
    queue_kb: float = 0.0       # total sorting-queue KB per PE
    pe_buffer_kb: float = 0.0   # PEB (Extensor baseline) or ARB+BRB (Maple)
    psb_kb: float = 0.0         # Maple partial-sum register file

    # bandwidths, words / cycle (array-wide)
    dram_wpc: float = 64.0      # 256 B/cycle (HBM-class, iso across variants)
    l1_wpc: float = 64.0        # aggregate SPM bandwidth
    pob_wpc: float = 384.0      # POB ports: 3 words/PE/cycle (banked)
    phase_overlap: float = 0.8  # multiply↔merge pipelining efficiency
    merge_rate: float = 2.0     # merge-network elements/cycle/PE (comparator tree)

    @property
    def total_macs(self) -> int:
        return self.n_pes * self.macs_per_pe


# -- reference configurations (paper §IV.B) ---------------------------------

def matraptor_baseline() -> AccelConfig:
    # MatRaptor (MICRO'20): 8 PEs, 1 MAC each, round-robin sorting queues.
    return AccelConfig(
        name="matraptor-baseline", family="matraptor", variant="baseline",
        n_pes=8, macs_per_pe=1, has_l1=True,
        n_queues=12, queue_kb=18.0, pe_buffer_kb=0.0,
    )


def matraptor_maple() -> AccelConfig:
    # 4 PEs × 2 MACs (iso-MAC = 8), one memory level (paper §IV.B.1).
    return AccelConfig(
        name="matraptor-maple", family="matraptor", variant="maple",
        n_pes=4, macs_per_pe=2, has_l1=False,
        pe_buffer_kb=4.5,   # ARB 0.5 KB + BRB 4 KB
        psb_kb=1.0,         # 256 × fp32 output-row tile registers
    )


def extensor_baseline() -> AccelConfig:
    # ExTensor (MICRO'19): 128 PEs (16×8), LLB + POB, PEB per PE.
    return AccelConfig(
        name="extensor-baseline", family="extensor", variant="baseline",
        n_pes=128, macs_per_pe=1, has_l1=True, llb_mb=30.0, has_pob=True,
        pe_buffer_kb=53.0,  # PEB
        l1_wpc=256.0,       # LLB is wide (ExTensor feeds 128 PEs)
    )


def extensor_maple() -> AccelConfig:
    # 8 PEs × 16 MACs (iso-MAC = 128), LLB kept, POB removed (§IV.B.2).
    return AccelConfig(
        name="extensor-maple", family="extensor", variant="maple",
        n_pes=8, macs_per_pe=16, has_l1=True, llb_mb=30.0, has_pob=False,
        pe_buffer_kb=6.0,   # ARB 0.5 KB + BRB 5.5 KB (16 lanes)
        psb_kb=1.0,
        l1_wpc=256.0,
    )


ALL_CONFIGS = (matraptor_baseline, matraptor_maple,
               extensor_baseline, extensor_maple)


# --------------------------------------------------------------------------
# Simulation result
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimResult:
    config: AccelConfig
    events: EventCounts
    cycles: float
    energy: float
    pe_area: en.PEArea
    array_area_mm2: float
    bottleneck: str


def _area_of(cfg: AccelConfig) -> en.PEArea:
    logic = cfg.macs_per_pe * en.MAC_MM2 + en.CTRL_MM2
    if cfg.variant == "maple":
        # parallel accumulate lanes: one adder per MAC beyond the MAC itself
        logic += cfg.macs_per_pe * en.ADDER_MM2
        buffers = en.sram_mm2(cfg.pe_buffer_kb) + en.regfile_mm2(cfg.psb_kb)
    elif cfg.family == "matraptor":
        buffers = en.sorting_queue_mm2(cfg.queue_kb)
        logic += en.ADDER_MM2  # merge comparator/adder
    else:  # extensor baseline
        buffers = en.sram_mm2(cfg.pe_buffer_kb)
    return en.PEArea(name=cfg.name, buffers_mm2=buffers, logic_mm2=logic)


# --------------------------------------------------------------------------
# Event + cycle accounting
# --------------------------------------------------------------------------

def simulate(cfg: AccelConfig, stats: SpGEMMStats) -> SimResult:
    """Count events and cycles for one C = A @ B run on ``cfg``."""
    P = float(stats.partial_products)
    nnz_a = float(stats.nnz_a)
    nnz_b = float(stats.nnz_b)
    nnz_c = float(stats.nnz_c)
    n_rows = float(stats.n_rows)

    ev = EventCounts()
    ev["mac"] = P

    # ---- operand delivery (common row-wise product structure) ------------
    # A: streamed once, value+col_id (+ row_ptr)
    a_words = 2 * nnz_a + n_rows
    # B: every A non-zero pulls its whole B row, value+col_id
    b_demand_words = 2 * P
    # C: final values+col_id (+row_ptr) written back
    c_words = 2 * nnz_c + n_rows

    if cfg.family == "extensor":
        # LLB tiles B with reuse: DRAM sees B once per K-round; PEs read the
        # full demand stream out of the LLB (fill = DRAM side, drain = PE
        # side — counted once each, no double charge).
        b_bytes = 2 * nnz_b * WORD_BYTES
        k_rounds = max(1, math.ceil(b_bytes / (cfg.llb_mb * 2 ** 20)))
        b_dram_words = 2 * nnz_b * k_rounds
        fill = b_dram_words + a_words + c_words
        drain = b_demand_words + a_words + c_words
        l1_words = fill + drain
    else:
        # Matraptor streams B rows per reference (SpBL is a staging buffer,
        # no cross-row reuse): DRAM sees the full demand stream.
        k_rounds = 1
        b_dram_words = b_demand_words
        if cfg.has_l1:
            l1_words = 2 * (b_demand_words + a_words + c_words)
        else:
            l1_words = 0.0  # Maple-Matraptor: ONE memory level (§IV.B.1)

    l2_words = a_words + b_dram_words + c_words
    noc_words = a_words + b_demand_words + c_words

    # ---- local (L0) traffic + accumulate path ----------------------------
    if cfg.variant == "maple":
        # ARB: write+read once per A element (value+col).  BRB: write+read
        # once per delivered B element.  PSB: RMW per partial product, one
        # final read per output value.
        l0 = 4 * nnz_a + 2 * b_demand_words + 2 * P + nnz_c
        merge_ops = 0.0
        intersect = 0.0
        cd = 0.0
        extra_l2 = 0.0
        pob_words = 0.0
    elif cfg.family == "matraptor":
        # sort-merge accumulate: every partial product is inserted into a
        # sorting queue (write val+col), then each merge pass re-reads and
        # re-writes the surviving stream.  Rows whose fiber count exceeds the
        # queue count need extra passes *through DRAM* (queue overflow).
        passes = matraptor_merge_passes(stats, cfg.n_queues)
        merged_words = float((stats.row_partials * passes).sum()) * 2
        l0 = 2 * b_demand_words + 2 * nnz_a + 2 * P + 2 * merged_words
        merge_ops = float((stats.row_partials * passes).sum())
        extra_pass_words = float(
            (stats.row_partials * np.maximum(passes - 1, 0)).sum()) * 2
        extra_l2 = 2 * extra_pass_words          # write + re-read via DRAM
        intersect = 0.0
        cd = P + nnz_a                           # decompress at PE boundary
        pob_words = 0.0
    else:
        # Extensor baseline: PEB staging + POB round trip per partial
        # product; K-rounds > 1 additionally round-trip partial C via DRAM.
        l0 = 2 * b_demand_words + 2 * nnz_a + 2 * P
        merge_ops = 0.0
        intersect = P                            # coordinate-match per pair
        cd = P + nnz_a
        pob_words = 4 * P                        # RMW × (value+coord)
        partial_c = min(nnz_c, P / max(k_rounds, 1))
        extra_l2 = (k_rounds - 1) * 4 * partial_c
        l1_words += pob_words

    ev["l0_access"] = l0
    ev["l1_access"] = l1_words
    ev["l2_access"] = l2_words + extra_l2
    ev["pe_transfer"] = noc_words
    ev["merge_op"] = merge_ops
    ev["intersect_op"] = intersect
    ev["cd_op"] = cd

    # ---- cycles: max over component bandwidths ---------------------------
    if cfg.variant == "maple":
        compute = maple_pe_cycles(stats, cfg.macs_per_pe, cfg.n_pes)
    else:
        # Extensor's tiling splits a row's work across PEs; Matraptor's
        # round-robin row assignment does not.
        compute = baseline_pe_cycles(stats, cfg.n_pes,
                                     row_atomic=cfg.family == "matraptor")
        if cfg.family == "matraptor":
            # multiply and merge are distinct phases of the round-robin
            # schedule; they pipeline across rows with efficiency
            # ``phase_overlap`` (the slower phase gates, the faster phase
            # hides all but (1-overlap) of itself).
            merge_cyc = merge_ops / (cfg.n_pes * cfg.merge_rate)
            compute = (max(compute, merge_cyc)
                       + (1 - cfg.phase_overlap) * min(compute, merge_cyc))

    components = {
        "compute": compute,
        "dram": (l2_words + extra_l2) / cfg.dram_wpc,
        # POB has its own ports; do not double-charge it on the LLB port.
        "l1": (l1_words - pob_words) / cfg.l1_wpc if cfg.has_l1 else 0.0,
    }
    if cfg.has_pob:
        components["pob"] = pob_words / cfg.pob_wpc
    bottleneck = max(components, key=components.get)
    cycles = components[bottleneck]
    if cfg.has_pob:
        # PE↔POB round trips are issue+wait latency on the PE side; the
        # schedule hides ``phase_overlap`` of it behind compute (the same
        # pipelining-efficiency treatment as the Matraptor merge phase).
        cycles += (1 - cfg.phase_overlap) * components["pob"]

    pe_area = _area_of(cfg)
    return SimResult(
        config=cfg, events=ev, cycles=cycles,
        energy=en.energy_of(ev), pe_area=pe_area,
        array_area_mm2=en.pe_array_area(pe_area, cfg.n_pes),
        bottleneck=bottleneck,
    )


# --------------------------------------------------------------------------
# Paper-style comparisons (Fig. 8 / Fig. 9)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Comparison:
    family: str
    energy_benefit_pct: float        # total incl. DRAM, Fig. 9(a)
    onchip_energy_benefit_pct: float  # excluding L2 (accounting-boundary alt)
    speedup_pct: float               # (baseline/maple - 1) × 100, Fig. 9(b)
    area_ratio: float                # baseline array / maple array, Fig. 8
    baseline: SimResult
    maple: SimResult


def _onchip_energy(r: SimResult) -> float:
    ev = EventCounts(**{k: v for k, v in r.events.items() if k != "l2_access"})
    return en.energy_of(ev)


def compare(family: str, stats: SpGEMMStats) -> Comparison:
    if family == "matraptor":
        base, mpl = matraptor_baseline(), matraptor_maple()
    elif family == "extensor":
        base, mpl = extensor_baseline(), extensor_maple()
    else:
        raise ValueError(family)
    rb = simulate(base, stats)
    rm = simulate(mpl, stats)
    return Comparison(
        family=family,
        energy_benefit_pct=(1 - rm.energy / rb.energy) * 100,
        onchip_energy_benefit_pct=(
            1 - _onchip_energy(rm) / _onchip_energy(rb)) * 100,
        speedup_pct=(rb.cycles / rm.cycles - 1) * 100,
        area_ratio=rb.array_area_mm2 / rm.array_area_mm2,
        baseline=rb, maple=rm,
    )
