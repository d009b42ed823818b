"""Maple SpMM kernels for Hopper (CUDA C++ under ``csrc/``), their plain
PyTorch versions, the plan layer and the public wrapper."""

from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                            maple_spmm_naive)
from repro_torch.kernels.ops import maple_spmm
from repro_torch.kernels.schedule import (ExecutionPlan, SpmmPlan, bsr_stats,
                                          plan_spmm)

__all__ = ["ExecutionPlan", "SpmmPlan", "bsr_stats", "maple_spmm",
           "maple_spmm_compact", "maple_spmm_naive", "plan_spmm"]
