"""Containers, formats, analytics and the Table-I generators (port of
``repro.core``)."""

from repro_torch.core import sparsity
from repro_torch.core.csr import CSR, BlockCSR, csr_transpose
from repro_torch.core.maple import (SpGEMMStats, analyze_spgemm,
                                    baseline_pe_cycles, maple_pe_cycles)

__all__ = ["CSR", "BlockCSR", "SpGEMMStats", "analyze_spgemm",
           "baseline_pe_cycles", "csr_transpose", "maple_pe_cycles",
           "sparsity"]
