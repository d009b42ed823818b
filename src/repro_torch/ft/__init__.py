"""Fault tolerance (port of ``repro.ft``): straggler detection.
Checkpointing (``repro.ft.checkpoint``) is not ported yet."""

from repro_torch.ft.straggler import (StepTimer, StragglerConfig,
                                      StragglerMonitor)

__all__ = ["StragglerConfig", "StragglerMonitor", "StepTimer"]
