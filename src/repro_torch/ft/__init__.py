"""Fault tolerance (port of ``repro.ft``): straggler detection and
checkpointing with resume (``checkpoint``)."""

from repro_torch.ft import checkpoint
from repro_torch.ft.straggler import (StepTimer, StragglerConfig,
                                      StragglerMonitor)

__all__ = ["StragglerConfig", "StragglerMonitor", "StepTimer", "checkpoint"]
