"""Synthetic sparse-matrix generators reproducing the paper's Table I
(port of ``repro.core.sparsity``: the same arithmetic and the same rng
draws, so one process gives the reference's matrices; the value lands on
the requested device).

SuiteSparse is not reachable offline, so each benchmark matrix is cloned by
(dim, nnz, density) plus a degree-skew family matched to its origin:

* graph / web matrices (wg, az, pg, wv, fb, cc) — power-law row degrees
  (Zipf-like), random column targets: models hub structure.
* FEM / PDE / circuit matrices (m2, mb, sc, of, cg, cs, f3, p3) — banded,
  quasi-diagonal with a few off-band entries: models mesh locality.

A scale factor lets tests/benchmarks run reduced clones with the *same*
density and skew (the quantities the dataflow model is sensitive to).

The rng seed adds ``hash(spec.abbrev)``, as the reference does.  Python
salts ``str`` hashes per process, so a clone is the same matrix only
within one process (or under a fixed ``PYTHONHASHSEED``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.csr import CSR


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    abbrev: str
    n: int          # square dimension
    nnz: int
    family: str     # "powerlaw" | "banded"


# Table I of the paper.
TABLE_I: Dict[str, MatrixSpec] = {
    s.abbrev: s
    for s in [
        MatrixSpec("web-Google", "wg", 916_000, 5_100_000, "powerlaw"),
        MatrixSpec("mario002", "m2", 390_000, 2_100_000, "banded"),
        MatrixSpec("amazon0312", "az", 401_000, 3_200_000, "powerlaw"),
        MatrixSpec("m133-b3", "mb", 200_000, 801_000, "banded"),
        MatrixSpec("scircuit", "sc", 171_000, 959_000, "banded"),
        MatrixSpec("p2pGnutella31", "pg", 63_000, 148_000, "powerlaw"),
        MatrixSpec("offshore", "of", 260_000, 4_200_000, "banded"),
        MatrixSpec("cage12", "cg", 130_000, 2_000_000, "banded"),
        MatrixSpec("2cubes-sphere", "cs", 101_000, 1_600_000, "banded"),
        MatrixSpec("filter3D", "f3", 106_000, 2_700_000, "banded"),
        MatrixSpec("ca-CondMat", "cc", 23_000, 187_000, "powerlaw"),
        MatrixSpec("wikiVote", "wv", 8_300, 104_000, "powerlaw"),
        MatrixSpec("poisson3Da", "p3", 14_000, 353_000, "banded"),
        MatrixSpec("facebook", "fb", 4_000, 176_000, "powerlaw"),
    ]
}


def _powerlaw_rows(n: int, nnz: int, rng: np.random.Generator,
                   alpha: float = 1.8) -> np.ndarray:
    """Row lengths ~ truncated Zipf, rescaled to sum to nnz."""
    raw = rng.zipf(alpha, size=n).astype(np.float64)
    raw = np.minimum(raw, n)  # cap at matrix width
    lens = np.maximum(np.round(raw * (nnz / raw.sum())), 0).astype(np.int64)
    # fix rounding drift
    drift = nnz - lens.sum()
    idx = rng.integers(0, n, size=abs(int(drift)))
    np.add.at(lens, idx, 1 if drift > 0 else -1)
    return np.clip(lens, 0, n)


def _banded_rows(n: int, nnz: int, rng: np.random.Generator) -> np.ndarray:
    """Near-uniform row lengths with small jitter (FEM-like)."""
    mean = nnz / n
    lens = rng.poisson(mean, size=n).astype(np.int64)
    drift = nnz - lens.sum()
    idx = rng.integers(0, n, size=abs(int(drift)))
    np.add.at(lens, idx, 1 if drift > 0 else -1)
    return np.clip(lens, 0, n)


def generate(spec: MatrixSpec, scale: float = 1.0, seed: int = 0,
             nnz_max: int | None = None, *, device="cuda") -> CSR:
    """Generate a CSR clone of ``spec`` scaled by ``scale`` (rows and nnz),
    preserving density and the degree-skew family; the value lands on
    ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + hash(spec.abbrev) % (2**31))
    n = max(int(spec.n * scale), 8)
    nnz = max(int(spec.nnz * scale), 8)
    nnz = min(nnz, n * n)

    if spec.family == "powerlaw":
        lens = _powerlaw_rows(n, nnz, rng)
    else:
        lens = _banded_rows(n, nnz, rng)

    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=row_ptr[1:])
    total = int(row_ptr[-1])

    cols = np.empty(total, dtype=np.int32)
    for i in range(n):
        li = int(lens[i])
        if li == 0:
            continue
        if spec.family == "banded":
            # entries clustered around the diagonal (bandwidth ~ 4x mean len)
            band = max(4 * li, 8)
            lo = max(0, i - band // 2)
            hi = min(n, lo + band)
            c = rng.choice(hi - lo, size=min(li, hi - lo), replace=False) + lo
        else:
            c = rng.choice(n, size=li, replace=False)
        c.sort()
        cols[row_ptr[i]: row_ptr[i] + c.size] = c
        lens[i] = c.size  # may shrink if band < li

    # rebuild row_ptr after any shrink
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=row_ptr[1:])
    total = int(row_ptr[-1])
    cols = cols[:total]

    vals = rng.standard_normal(total).astype(np.float32)

    cap = nnz_max if nnz_max is not None else total
    if cap < total:
        raise ValueError(f"nnz_max={cap} < generated nnz={total}")
    value = np.zeros(cap, dtype=np.float32)
    col_id = np.full(cap, -1, dtype=np.int32)
    value[:total] = vals
    col_id[:total] = cols

    return CSR(value=torch.from_numpy(value).to(dev), col_id=col_id,
               row_ptr=row_ptr.astype(np.int32), shape=(n, n))


def table_i_clones(scale: float = 0.01, seed: int = 0, *,
                   device="cuda") -> Dict[str, CSR]:
    """All 14 Table-I matrices at the given scale."""
    return {ab: generate(sp, scale=scale, seed=seed, device=device)
            for ab, sp in TABLE_I.items()}


def block_pattern_mask(kind: str, rng: np.random.Generator,
                       gm: int, gk: int) -> np.ndarray:
    """Block-granular sparsity masks — the golden workload patterns the
    scheduler sweeps, the autotune smoke, and the autotuner tests share
    (one source of truth so the bench gate and the CI autotune job can
    never drift onto different patterns).

    ``uniform`` iid 30% block density, ``power_law`` Zipf-ish block-row
    lengths (a few dominant rows — the MatRaptor worst case the chunked
    plan exists to fix), ``banded`` a 3-block lower band (FEM locality).
    """
    if kind == "uniform":
        mask = rng.random((gm, gk)) < 0.3
    elif kind == "power_law":
        mask = np.zeros((gm, gk), bool)
        for i in range(gm):
            ln = max(1, int(round(gk * (i + 1) ** -1.2)))
            mask[i, rng.choice(gk, size=ln, replace=False)] = True
    elif kind == "banded":
        mask = np.zeros((gm, gk), bool)
        for i in range(gm):
            for j in range(gk):
                if 0 <= i - j < 3:
                    mask[i, j] = True
    else:
        raise ValueError(kind)
    # no fully-empty matrix
    if not mask.any():
        mask[0, 0] = True
    return mask


def element_pattern_mask(kind: str, rng: np.random.Generator,
                         m: int, k: int) -> np.ndarray:
    """Element-granular sparsity masks for the SpGEMM sweeps.

    The three workload axes the benchmarks and the accelerator sim share
    (one source of truth so they never desynchronize): ``uniform`` iid
    density, ``power_law`` Zipf-ish row lengths (the skewed regime
    work-balancing exists for), ``banded`` FEM-like locality.
    """
    if kind == "uniform":
        mask = rng.random((m, k)) < 0.15
    elif kind == "power_law":
        mask = np.zeros((m, k), bool)
        for i in range(m):
            ln = max(1, int(round(k * (i + 1) ** -1.2)))
            mask[i, rng.choice(k, size=ln, replace=False)] = True
    elif kind == "banded":
        mask = np.abs(np.subtract.outer(np.arange(m), np.arange(k))) < 2
    else:
        raise ValueError(kind)
    if not mask.any():
        mask[0, 0] = True
    return mask


SPGEMM_SPLIT_CASES = ("long_b_rows", "long_fibers", "unused_and_empty",
                      "long_row")


def spgemm_split_masks(case: str, rng: np.random.Generator):
    """Element masks ``(A, B)`` of a SpGEMM that reach past each split of
    its CUDA kernels (a group of 8 lanes, three steps of 8 terms loaded at
    once, a warp, slot and fiber batches), for the card tests and the chip
    smoke alike:

    * ``long_b_rows`` — B rows of 48 and 120 entries, empty A rows;
    * ``long_fibers`` — A column fibers of 60 and 20 slots;
    * ``unused_and_empty`` — B rows no A slot consumes, empty A rows, and
      an A row whose slots take only empty B rows (slots, no C entry);
    * ``long_row`` — one output row of more than 256 entries.
    """
    if case == "long_b_rows":
        am, bm = rng.random((30, 40)) < 0.3, rng.random((40, 120)) < 0.15
        am[::6] = False
        am[:, 3] = True
        bm[3], bm[7, :48] = True, True
    elif case == "long_fibers":
        am, bm = rng.random((60, 30)) < 0.1, rng.random((30, 40)) < 0.3
        am[:, 4] = True
        am[:20, 9] = True
    elif case == "unused_and_empty":
        am, bm = rng.random((24, 24)) < 0.4, rng.random((24, 30)) < 0.4
        am[:, ::3] = False
        am[::5] = False
        bm[1] = bm[2] = False
        am[7] = False
        am[7, [1, 2]] = True
    elif case == "long_row":
        am, bm = rng.random((12, 50)) < 0.1, rng.random((50, 400)) < 0.05
        am[0] = True
    else:
        raise ValueError(case)
    return am, bm
