"""Multi-device execution (port of ``repro.distributed``): the mesh, the
logical-axis sharding rules and the GPipe pipeline."""

from repro_torch.distributed import pipeline, sharding

__all__ = ["pipeline", "sharding"]
