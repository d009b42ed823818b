"""PSB run and sweep boundaries (port of ``repro.kernels.accum``).

Every Maple kernel zeroes its PSB on the first step of a run, accumulates
across the run and flushes once at the last step.  On Hopper the run
boundaries are resolved on the host instead of inside the kernel: the
planned kernel gets one thread block per run (see
``SpmmPlan.runs``), so the comparison below runs over host numpy arrays —
``s`` may be a scalar step or a whole ``np.arange(steps)``.
:func:`tile_bounds` is the block SDDMM's sweep: one PSB per block,
accumulated over every (batch, tile) visit and flushed once.
"""

from __future__ import annotations

import numpy as np


def run_bounds(step_row, base, s, steps):
    """Row-run boundaries at flattened step ``base + s`` of a lane.

    ``step_row`` is the flattened row stream, ``base`` the lane's offset
    into it, ``steps`` the per-lane step count.  Returns ``(row, is_first,
    is_last)``: the output row the step accumulates into and whether the
    step opens / closes its (lane, row) PSB run.
    """
    step_row = np.asarray(step_row)
    s = np.asarray(s)
    row = step_row[base + s]
    is_first = (s == 0) | (row != step_row[base + np.maximum(s - 1, 0)])
    is_last = (s == steps - 1) | (
        row != step_row[base + np.minimum(s + 1, steps - 1)])
    return row, is_first, is_last


def tile_bounds(g, j, n_g, n_j):
    """Sweep boundaries for a PSB revisited across a (batch, tile) walk:
    the first visit is ``(0, 0)``, the last ``(n_g - 1, n_j - 1)``.
    Returns ``(is_first, is_last)``; scalars or arrays alike."""
    is_first = np.logical_and(np.equal(g, 0), np.equal(j, 0))
    is_last = np.logical_and(np.equal(g, n_g - 1), np.equal(j, n_j - 1))
    return is_first, is_last
