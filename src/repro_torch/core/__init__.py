"""Paper core (port of ``repro.core``): CSR containers and formats, the
Table-I generators, Gustavson's row-wise product as torch oracles, the
Maple PE event model, the four §IV accelerator configurations and the
Accelergy-style energy / area model."""

from repro_torch.core import energy, sparsity
from repro_torch.core.csr import CSR, BlockCSR, csr_transpose
from repro_torch.core.dataflows import (AccelConfig, Comparison, SimResult,
                                        compare, extensor_baseline,
                                        extensor_maple, matraptor_baseline,
                                        matraptor_maple, simulate)
from repro_torch.core.formats import (BitmapBlocked, EllPack, SparseFormat,
                                      as_block_csr, as_element_csr,
                                      from_dense, to_bitmap, to_ell)
from repro_torch.core.gustavson import (dense_oracle, spmm_rowwise,
                                        spmspm_rowwise, spmspm_rowwise_scan)
from repro_torch.core.maple import (EventCounts, SpGEMMStats, analyze_spgemm,
                                    baseline_pe_cycles, maple_pe_cycles)

__all__ = [
    "CSR", "BlockCSR", "EllPack", "BitmapBlocked", "SparseFormat",
    "from_dense", "as_block_csr", "as_element_csr", "to_ell", "to_bitmap",
    "spmm_rowwise", "spmspm_rowwise",
    "spmspm_rowwise_scan", "dense_oracle", "EventCounts", "SpGEMMStats",
    "analyze_spgemm", "AccelConfig", "SimResult", "Comparison", "simulate",
    "compare", "matraptor_baseline", "matraptor_maple", "extensor_baseline",
    "extensor_maple", "energy", "sparsity",
    "baseline_pe_cycles", "csr_transpose", "maple_pe_cycles",
]
