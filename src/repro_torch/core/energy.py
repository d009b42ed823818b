"""Accelergy-style energy table + CACTI/Aladdin-style area model (paper Fig. 3, Fig. 8).

Energy: the paper prices each *event* (arithmetic op or word moved between
levels) with a per-access energy at 45 nm, normalized here to one MAC = 1.0.
The table follows Fig. 3's ordering — arithmetic ≪ L0 ≪ PE↔PE ≪ L1 ≪ L2 —
with values consistent with the public Accelergy / Eyeriss 45 nm estimates
(RF ≈ MAC, inter-PE ≈ 2×, 100 KB-class SPM ≈ 6×, DRAM ≈ 200×).

Area: buffer area is a linear per-KB model with a fixed decoder/periphery
overhead (CACTI-like in the 1–64 KB regime); *sorting* queues (Matraptor's
systolic priority queues) carry a per-KB multiplier because every entry owns
a comparator + shift path; MACs and merge/intersect logic use Aladdin-class
per-unit constants.  All constants are module-level and documented so the
benchmark can print them next to the results (EXPERIMENTS §Paper).

Port of ``repro.core.energy``: every constant equals the reference's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.maple import EventCounts

# --------------------------------------------------------------------------
# Energy (normalized: 1.0 = one 32-bit MAC @ 45nm ≈ 2.2 pJ)
# --------------------------------------------------------------------------

ENERGY_PER_EVENT = {
    "mac": 1.0,            # 32-bit multiply-accumulate
    "merge_op": 0.45,      # comparator + swap in a sorting/merge network
    "intersect_op": 0.35,  # coordinate match (Extensor-style intersection)
    "cd_op": 0.5,          # CSR compress/decompress per element
    "l0_access": 1.0,      # ARB/BRB/PSB / queue / PEB word access (RF class)
    "pe_transfer": 2.0,    # one word over the NoC / crossbar hop
    "l1_access": 6.0,      # SPM word access (SpAL/SpBL/LLB/POB, 100 KB class)
    "l2_access": 200.0,    # DRAM word access
}


def energy_of(events: EventCounts) -> float:
    """Total normalized energy of an event trace."""
    return sum(events[k] * ENERGY_PER_EVENT[k] for k in events)


def energy_breakdown(events: EventCounts) -> dict:
    return {k: events[k] * ENERGY_PER_EVENT[k] for k in events}


# --------------------------------------------------------------------------
# Area (mm^2 @ 45nm)
# --------------------------------------------------------------------------

MAC_MM2 = 0.004          # 32-bit FP MAC (Aladdin 45nm class)
ADDER_MM2 = 0.0008       # 32-bit adder (PSB accumulate lane)
CTRL_MM2 = 0.002         # per-PE control / metadata walk FSM
SRAM_FIXED_MM2 = 0.003   # decoder/periphery floor of a small SPM
SRAM_MM2_PER_KB = 0.0016  # bit-array slope, plain single-port SRAM
SORT_QUEUE_FACTOR = 2.5  # systolic priority queue: comparator+shift per entry
RF_MM2_PER_KB = 0.0060   # register-file implemented buffer (PSB)


def sram_mm2(kb: float) -> float:
    if kb <= 0:
        return 0.0
    return SRAM_FIXED_MM2 + SRAM_MM2_PER_KB * kb


def sorting_queue_mm2(kb: float) -> float:
    if kb <= 0:
        return 0.0
    return SRAM_FIXED_MM2 + SORT_QUEUE_FACTOR * SRAM_MM2_PER_KB * kb


def regfile_mm2(kb: float) -> float:
    return RF_MM2_PER_KB * kb


@dataclasses.dataclass(frozen=True)
class PEArea:
    """Per-PE area split, mirroring the stacked bars of Fig. 8."""

    name: str
    buffers_mm2: float
    logic_mm2: float   # MACs + adders + control ("Maple logic" in Fig. 8)

    @property
    def total_mm2(self) -> float:
        return self.buffers_mm2 + self.logic_mm2


def pe_array_area(pe: PEArea, n_pes: int) -> float:
    return pe.total_mm2 * n_pes
