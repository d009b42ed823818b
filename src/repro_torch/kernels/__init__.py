"""Maple kernels for Hopper (CUDA C++ under ``csrc/``): the SpMM forward
kernels, the block SDDMM of the backward, their plain PyTorch versions,
the plan layer and the public wrapper."""

from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr
from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                            maple_spmm_naive)
from repro_torch.kernels.ops import maple_spmm
from repro_torch.kernels.schedule import (ExecutionPlan, SpmmPlan,
                                          SpmmTrainPlan, bsr_stats,
                                          plan_spmm, plan_spmm_vjp)

__all__ = ["ExecutionPlan", "SpmmPlan", "SpmmTrainPlan", "bsr_stats",
           "maple_sddmm_bsr", "maple_spmm", "maple_spmm_compact",
           "maple_spmm_naive", "plan_spmm", "plan_spmm_vjp"]
