"""Containers, formats, analytics and the Table-I generators (port of
``repro.core``)."""

from repro_torch.core import sparsity
from repro_torch.core.csr import CSR, BlockCSR, csr_transpose
from repro_torch.core.formats import (BitmapBlocked, EllPack, SparseFormat,
                                      as_block_csr, as_element_csr,
                                      from_dense, to_bitmap, to_ell)
from repro_torch.core.maple import (SpGEMMStats, analyze_spgemm,
                                    baseline_pe_cycles, maple_pe_cycles)

__all__ = ["CSR", "BlockCSR", "EllPack", "BitmapBlocked", "SparseFormat",
           "from_dense", "as_block_csr", "as_element_csr", "to_ell",
           "to_bitmap", "SpGEMMStats", "analyze_spgemm",
           "baseline_pe_cycles", "csr_transpose", "maple_pe_cycles",
           "sparsity"]
