"""Framework configuration.

The reference hardwires its tuning constants at compile time
(reference: PreProcessing/serial_newblock_clock.cpp:18-20 ``SECT=2048``,
transmat.h:339 region threshold ``512*1024/8``, v8sort.h:58 panel target 2048 rows,
v8sort.h:21-23 row-length cap 33, v8 width 8).  Here they are one dataclass.
The values and field names are those of ``spmm_tpu.config.Config``, so both
packages preprocess a matrix into the same packed format; the VMEM/lane
fields describe that shared format, not this card.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # --- preprocessing (reference-analog constants) -------------------------
    #: column-section width for the dominant-section row reorder
    #: (reference SECT=2048, serial_newblock_clock.cpp:19)
    section_size: int = 2048
    #: distinct-column working-set budget per region.  The reference sizes this
    #: for a 512 KB cache of doubles (65536, transmat.h:339); on TPU it bounds
    #: the per-region RHS panel that must fit VMEM:
    #:   region_budget * spmm_k * 4B  <=  vmem_panel_bytes
    region_budget: int = 65536
    #: target rows per panel before nnz balancing (reference 2048, v8sort.h:58)
    panel_rows: int = 2048
    #: vector-group width — 8 rows = TPU fp32 sublane count
    #: (reference v8 width, v8sort.h:64,194).  The packed-format CONSUMERS
    #: (unpack_to_csr, ops/blocked.py) implement the reference's 8-row
    #: interleave contract; non-8 values exercise the preprocessing passes
    #: but the resulting pack is not consumable by them
    group_width: int = 8
    #: rows longer than this are not v8-grouped (reference cap 32, v8sort.h:21-23)
    max_group_row_len: int = 32

    # --- kernels -------------------------------------------------------------
    #: SpMM dense-RHS column counts used by default benchmarks
    spmm_k: int = 128
    #: VMEM budget a gathered RHS panel may occupy inside a kernel (bytes)
    vmem_panel_bytes: int = 4 * 1024 * 1024
    #: lane tile (always 128 on TPU)
    lane: int = 128
    #: sublane tile for fp32
    sublane: int = 8

    # --- distribution ----------------------------------------------------------
    #: mesh axis name for row/region data parallelism
    rows_axis: str = "rows"
    #: mesh axis name for RHS-column model parallelism
    cols_axis: str = "cols"

    def region_budget_for_k(self, k: int, bytes_per_el: int = 4) -> int:
        """Largest distinct-column budget whose gathered (budget, k) panel fits
        the configured VMEM panel allowance."""
        b = self.vmem_panel_bytes // max(1, k * bytes_per_el)
        # keep sublane alignment
        return max(self.sublane, (b // self.sublane) * self.sublane)


def default_config() -> Config:
    return Config()
