"""Multi-device execution (port of ``repro.distributed``): the mesh of the
partitioned Maple kernels."""

from repro_torch.distributed import sharding

__all__ = ["sharding"]
