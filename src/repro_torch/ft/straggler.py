"""Straggler monitoring and restart-policy hooks (a copy of the
pure-Python ``repro.ft.straggler``).

Every host reports its per-step wall time; a host slower than the fleet
median × ``tolerance`` for ``patience`` consecutive steps is flagged
for preemption or replacement, and unflagged after ``patience``
consecutive healthy steps.  The action on a flag is outside this
library; the detection is here.  A single process feeds the monitor in
the training launcher, as each host's agent would.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50           # sliding window of steps
    tolerance: float = 1.5     # flag if slower than fleet median × tolerance
    patience: int = 5          # consecutive slow (healthy) steps before
    #                            flagging (unflagging)


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.history: Dict[str, collections.deque] = {}
        self.slow_streak: Dict[str, int] = collections.defaultdict(int)
        self.healthy_streak: Dict[str, int] = collections.defaultdict(int)
        self.flagged: List[str] = []

    def record(self, host: str, step_seconds: float) -> None:
        self.history.setdefault(
            host, collections.deque(maxlen=self.cfg.window)
        ).append(step_seconds)

    def _baseline(self) -> Optional[float]:
        """Fleet median — robust to the stragglers themselves (a pooled
        p99 would absorb the outliers it is supposed to catch)."""
        all_times = sorted(t for dq in self.history.values() for t in dq)
        if len(all_times) < 10:
            return None
        return all_times[len(all_times) // 2]

    def check(self) -> tuple:
        """Update streaks from the latest sample of each host; returns
        ``(newly_flagged, recovered)`` host lists.

        A host flags after ``patience`` consecutive slow steps and —
        symmetrically — *unflags* after ``patience`` consecutive healthy
        steps (the hysteresis keeps a borderline host from flapping the
        drain API every other step).  The old behavior flagged forever:
        a host that hit one slow patch — a checkpoint write, a neighbor's
        network burst — stayed on the preemption list for the rest of the
        job even after thousands of healthy steps.
        """
        base = self._baseline()
        if base is None:
            return [], []
        newly, recovered = [], []
        for host, dq in self.history.items():
            if dq and dq[-1] > base * self.cfg.tolerance:
                self.slow_streak[host] += 1
                self.healthy_streak[host] = 0
            else:
                self.slow_streak[host] = 0
                self.healthy_streak[host] += 1
            if (self.slow_streak[host] >= self.cfg.patience
                    and host not in self.flagged):
                self.flagged.append(host)
                newly.append(host)
            elif (host in self.flagged
                    and self.healthy_streak[host] >= self.cfg.patience):
                self.flagged.remove(host)
                recovered.append(host)
        return newly, recovered


class StepTimer:
    """Context helper: feeds wall time into the monitor."""

    def __init__(self, monitor: StragglerMonitor, host: str):
        self.monitor = monitor
        self.host = host

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.monitor.record(self.host, time.perf_counter() - self.t0)
        return False
