"""PSB run boundaries (port of ``repro.kernels.accum.run_bounds``).

Every Maple kernel zeroes its PSB on the first step of a run, accumulates
across the run and flushes once at the last step.  On Hopper the run
boundaries are resolved on the host instead of inside the kernel: the
planned kernel gets one thread block per run (see
``SpmmPlan.runs``), so the comparison below runs over host numpy arrays —
``s`` may be a scalar step or a whole ``np.arange(steps)``.
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
