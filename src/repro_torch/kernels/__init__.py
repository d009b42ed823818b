"""Maple kernels for Hopper (CUDA C++ under ``csrc/``): the SpMM forward
kernels and the block SDDMM of its backward, the SpGEMM numeric phase with
the CSR SDDMM and dB of its backward, the element walk with a dense B,
their plain PyTorch versions, the plan layer and the public wrappers."""

from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr, maple_sddmm_csr
from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                            maple_spmm_naive)
from repro_torch.kernels.ops import (csr_to_ell, maple_spgemm, maple_spmm,
                                     maple_spmspm)
from repro_torch.kernels.schedule import (ExecutionPlan, SpgemmPlan,
                                          SpmmPlan, SpmmTrainPlan, bsr_stats,
                                          plan_spgemm, plan_spmm,
                                          plan_spmm_vjp)

__all__ = ["ExecutionPlan", "SpgemmPlan", "SpmmPlan", "SpmmTrainPlan",
           "bsr_stats", "csr_to_ell", "maple_sddmm_bsr", "maple_sddmm_csr",
           "maple_spgemm", "maple_spmm", "maple_spmm_compact",
           "maple_spmm_naive", "maple_spmspm", "plan_spgemm", "plan_spmm",
           "plan_spmm_vjp"]
