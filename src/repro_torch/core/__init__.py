"""Containers and analytics (port of ``repro.core``)."""

from repro_torch.core.csr import CSR, BlockCSR
from repro_torch.core.maple import (SpGEMMStats, analyze_spgemm,
                                    baseline_pe_cycles, maple_pe_cycles)

__all__ = ["CSR", "BlockCSR", "SpGEMMStats", "analyze_spgemm",
           "baseline_pe_cycles", "maple_pe_cycles"]
