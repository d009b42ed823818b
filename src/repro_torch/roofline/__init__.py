"""The roofline of a dry-run cell (port of ``repro.roofline``)."""

from repro_torch.roofline import analysis

__all__ = ["analysis"]
