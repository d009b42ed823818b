"""Maple kernels for Hopper (CUDA C++ under ``csrc/``): the SpMM forward
kernels (naive, compact and rmw layouts) and the block SDDMM of its
backward, the SpGEMM numeric phase with the CSR SDDMM and dB of its
backward, the element walk with a dense B, the MoE grouped GEMM,
block-sparse local attention, their plain PyTorch versions, the plan
layer (single-device and mesh-partitioned), row reordering, the plan
autotuner and the public wrappers."""

from repro_torch.kernels.autotune import (SearchReport, auto_plan,
                                          fit_calibration, load_calibration,
                                          plan_cache_clear, plan_cache_stats,
                                          plan_search, plan_search_vjp,
                                          time_interleaved)
from repro_torch.kernels.block_attn import (block_attention,
                                           local_window_kv_map)
from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr, maple_sddmm_csr
from repro_torch.kernels.maple_spmm import (maple_spmm_compact,
                                            maple_spmm_naive,
                                            maple_spmm_planned)
from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                              maple_spgemm_numeric)
from repro_torch.kernels.maple_spmspm import maple_spmspm_ell
from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_dw
from repro_torch.kernels.ops import (csr_to_ell, local_block_attention,
                                     maple_spgemm, maple_spmm, maple_spmspm,
                                     moe_expert_gemm)
from repro_torch.kernels.partition import (PartitionedSpmmPlan,
                                           plan_partitioned_spmm,
                                           plan_partitioned_spmm_vjp)
from repro_torch.kernels.reorder import (RowReorder, apply_reorder,
                                         plan_reordered_spmm, reorder_rows)
from repro_torch.kernels.schedule import (ExecutionPlan, SpgemmPlan,
                                          SpmmPlan, SpmmTrainPlan, bsr_stats,
                                          pattern_fingerprint, plan_spgemm,
                                          plan_spmm, plan_spmm_vjp,
                                          spmm_knob_space)



def launch_counters() -> dict:
    """Every kernel wrapper that counts its launches (its ``launches``
    attribute, one a launch of its kernel), by name."""
    fns = (maple_spmm_naive, maple_spmm_compact, maple_spmm_planned,
           maple_sddmm_bsr, maple_sddmm_csr, maple_spgemm_numeric,
           maple_spgemm_db, maple_spmspm_ell, moe_gemm, moe_gemm_dw,
           block_attention)
    return {f.__name__: f for f in fns}


__all__ = ["ExecutionPlan", "PartitionedSpmmPlan", "RowReorder", "SearchReport", "SpgemmPlan",
           "SpmmPlan", "SpmmTrainPlan", "apply_reorder", "auto_plan",
           "block_attention", "bsr_stats", "csr_to_ell", "fit_calibration",
           "launch_counters",
           "load_calibration", "local_block_attention",
           "local_window_kv_map", "maple_sddmm_bsr", "maple_sddmm_csr",
           "maple_spgemm", "maple_spmm", "maple_spmm_compact",
           "maple_spmm_naive", "maple_spmm_planned", "maple_spmspm",
           "moe_expert_gemm", "moe_gemm", "pattern_fingerprint",
           "plan_cache_clear", "plan_cache_stats", "plan_partitioned_spmm",
           "plan_partitioned_spmm_vjp", "plan_reordered_spmm",
           "plan_search", "plan_search_vjp", "plan_spgemm", "plan_spmm",
           "plan_spmm_vjp", "reorder_rows", "spmm_knob_space",
           "time_interleaved"]
