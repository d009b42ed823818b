"""Maple PE functional model and event counting (port of
``repro.core.maple``): the workload statistics behind the SpGEMM planner
and ``ExecutionPlan.predicted_cycles``, the event counters the
accelerator model (``core.dataflows``, ``core.energy``) prices, and the
cycle models of the Maple and single-MAC PEs.

Host-side numpy over CSR metadata, identical arithmetic to the reference.

Terminology (paper §II/III): ARB, the A-row buffer; BRB, the B-rows
buffer; PSB, the partial-sum buffer (a 1×N register file addressed by
j' = B.col_id[k']); P, the partial products Σ_{(i,k') ∈ nnz(A)}
nnz(B[k',:]).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

from repro_torch.core.csr import CSR


@dataclasses.dataclass(frozen=True)
class SpGEMMStats:
    """Metadata-derived statistics of one C = A @ B row-wise product run."""

    n_rows: int
    n_cols: int
    nnz_a: int
    nnz_b: int
    partial_products: int      # P: multiplies = accumulate ops
    nnz_c: int                 # distinct output coordinates
    a_row_len: np.ndarray      # (n_rows,) nnz per row of A
    b_row_len: np.ndarray      # (n_rows_b,) nnz per row of B
    row_partials: np.ndarray   # (n_rows,) partial products per A row
    row_fibers: np.ndarray     # (n_rows,) = nnz(A[i,:])
    b_row_refs: np.ndarray     # (n_rows_b,) column histogram of A

    @property
    def avg_b_row_len(self) -> float:
        referenced = self.b_row_len[self.b_row_len > 0]
        return float(referenced.mean()) if referenced.size else 0.0

    @property
    def compaction(self) -> float:
        """nnz_c / P — how much the accumulate phase compacts partials."""
        return self.nnz_c / max(self.partial_products, 1)


def expand_partials(a: CSR, b: CSR):
    """Every partial product of ``C = A @ B`` as coordinates (Eq. 6):
    ``(a_slot, out_row, out_col, b_off)`` in A-metadata walk order."""
    a_rptr = np.asarray(a.row_ptr).astype(np.int64)
    b_rptr = np.asarray(b.row_ptr).astype(np.int64)
    nnz_a = int(a_rptr[-1])
    a_cols = np.asarray(a.col_id)[:nnz_a].astype(np.int64)
    b_cols = np.asarray(b.col_id)
    a_row_len = np.diff(a_rptr)
    b_row_len = np.diff(b_rptr)

    per_nnz_work = b_row_len[a_cols]
    partials = int(per_nnz_work.sum())
    a_row_of_nnz = np.repeat(np.arange(a_row_len.size), a_row_len)

    a_slot = np.repeat(np.arange(nnz_a, dtype=np.int64), per_nnz_work)
    out_row = np.repeat(a_row_of_nnz, per_nnz_work)
    cum = np.concatenate([[0], np.cumsum(per_nnz_work)[:-1]])
    b_off = np.arange(partials, dtype=np.int64) - np.repeat(cum, per_nnz_work)
    starts = b_rptr[a_cols]
    out_col = b_cols[np.repeat(starts, per_nnz_work) + b_off].astype(np.int64)
    return a_slot, out_row, out_col, b_off


def analyze_spgemm(a: CSR, b: CSR | None = None,
                   exact_output: bool = True) -> SpGEMMStats:
    """Count everything a row-wise product dataflow moves (the reference's
    ``analyze_spgemm``, same arithmetic).  ``b=None`` means B = A (the
    paper's protocol).  ``exact_output=True`` counts nnz(C) exactly by
    expanding the partial coordinates (O(P) memory); ``False`` gives the
    per-row expectation of P uniform draws into the row's width."""
    if b is None:
        b = a
    a_rptr = np.asarray(a.row_ptr).astype(np.int64)
    a_cols = np.asarray(a.col_id)
    b_rptr = np.asarray(b.row_ptr).astype(np.int64)

    nnz_a = int(a_rptr[-1])
    nnz_b = int(b_rptr[-1])
    a_cols = a_cols[:nnz_a].astype(np.int64)
    a_row_len = np.diff(a_rptr)
    b_row_len = np.diff(b_rptr)

    per_nnz_work = b_row_len[a_cols]
    partials = int(per_nnz_work.sum())

    a_row_of_nnz = np.repeat(np.arange(a_row_len.size), a_row_len)
    row_partials = np.bincount(a_row_of_nnz, weights=per_nnz_work,
                               minlength=a_row_len.size).astype(np.int64)

    if exact_output and partials > 0:
        _, out_i, out_j, _ = expand_partials(a, b)
        nnz_c = int(np.unique(out_i * b.shape[1] + out_j).size)
    elif partials == 0 or b.shape[1] == 0:
        nnz_c = 0
    else:
        n_out = b.shape[1]
        with np.errstate(over="ignore"):
            exp_row = n_out * (1.0 - np.exp(-row_partials / n_out))
        nnz_c = int(exp_row.sum())

    b_row_refs = np.bincount(a_cols, minlength=b_row_len.size).astype(np.int64)

    return SpGEMMStats(
        n_rows=a.shape[0], n_cols=b.shape[1],
        nnz_a=nnz_a, nnz_b=nnz_b,
        partial_products=partials, nnz_c=nnz_c,
        a_row_len=a_row_len, b_row_len=b_row_len,
        row_partials=row_partials, row_fibers=a_row_len.copy(),
        b_row_refs=b_row_refs,
    )


# every counter is "number of word-granular events" (one word = one value or
# one metadata entry; C/D + IN are per-element operations)
EVENT_KINDS = (
    "mac",            # multiply-accumulate ops
    "merge_op",       # comparator/merge ops (sort-based accumulate only)
    "intersect_op",   # explicit intersection ops (baseline Extensor)
    "cd_op",          # CSR compress/decompress ops at PE boundary
    "l0_access",      # ARB/BRB/PSB or queue/PEB accesses (reg/FIFO level)
    "pe_transfer",    # PE↔PE / NoC word transfers
    "l1_access",      # SPM (SpAL/SpBL/LLB/POB) accesses
    "l2_access",      # DRAM word transfers
)


class EventCounts(Dict[str, float]):
    """A dict of event kind → count with arithmetic convenience; every
    kind of :data:`EVENT_KINDS` is present, in that order."""

    def __init__(self, **kw):
        super().__init__({k: 0.0 for k in EVENT_KINDS})
        for k, v in kw.items():
            if k not in EVENT_KINDS:
                raise KeyError(k)
            self[k] = float(v)

    def __add__(self, other: "EventCounts") -> "EventCounts":
        out = EventCounts()
        for k in EVENT_KINDS:
            out[k] = self[k] + other[k]
        return out

    def scaled(self, f: float) -> "EventCounts":
        out = EventCounts()
        for k in EVENT_KINDS:
            out[k] = self[k] * f
        return out


def maple_pe_cycles(stats: SpGEMMStats, macs_per_pe: int, n_pes: int) -> float:
    """Maple multi-MAC schedule: a row with p partial products takes
    ceil(p/m) cycles; rows spread over PEs, the heaviest row bounds it."""
    if stats.partial_products == 0:
        return 0.0
    per_row = np.ceil(stats.row_partials / macs_per_pe)
    mean_shard = float(per_row.sum()) / n_pes
    max_row = float(per_row.max(initial=0.0))
    return max(mean_shard, max_row)


def baseline_pe_cycles(stats: SpGEMMStats, n_pes: int,
                       row_atomic: bool = True) -> float:
    """Single-MAC PE: one partial product per cycle.  ``row_atomic=True``
    (Matraptor) pins each A row to one PE, so the heaviest row bounds the
    schedule; ``False`` (Extensor) lets the tiling split a row's work."""
    if stats.partial_products == 0:
        return 0.0
    mean_shard = stats.partial_products / n_pes
    if not row_atomic:
        return mean_shard
    max_row = float(stats.row_partials.max(initial=0.0))
    return max(mean_shard, max_row)


def matraptor_merge_passes(stats: SpGEMMStats, n_queues: int) -> np.ndarray:
    """Sorting-queue rounds per output row for the baseline Matraptor:
    row i merges nnz(A[i,:]) sorted fibers, Q at a time, so it takes
    ``ceil(log_Q(fibers))`` passes (at least one)."""
    fibers = np.maximum(stats.row_fibers, 1)
    with np.errstate(divide="ignore"):
        passes = np.ceil(np.log(fibers) / math.log(max(n_queues, 2)))
    return np.maximum(passes, 1.0)
