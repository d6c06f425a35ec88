from spmm_tpu_torch.ops.spmm import spmm, spmv, spmm_xla, spmv_xla
from spmm_tpu_torch.ops.spgemm import spgemm_sorted, spgemm_coo_padded, spgemm_expand_bound
from spmm_tpu_torch.ops.slab_spgemm import (
    spgemm_chain_device,
    spgemm_plan,
    spgemm_plan_revalue,
    spgemm_slab,
    spgemm_slab_big,
    spgemm_slab_csr,
    spgemm_slab_device,
)
from spmm_tpu_torch.ops.ell_spmm import ell_spmm, ell_spmv
from spmm_tpu_torch.ops.ell_kernel import (
    ell_slab_spmm,
    ell_slab_spmm_reference,
    ell_slabs_sddmm,
    ell_slabs_sddmm_reference,
    ell_slabs_spmm,
    ell_slabs_spmm_reference,
    ell_slabs_spmm_transposed,
    ell_slabs_spmm_transposed_reference,
    transposed_slabs,
)
from spmm_tpu_torch.ops.bsr_kernel import (
    bsr_data_grad,
    bsr_spmm,
    bsr_spmm_reference,
    bsr_spmm_transposed,
    bsr_spmm_transposed_reference,
    bsr_spmv,
)
from spmm_tpu_torch.ops.blocked import (
    blocked_chain_spmv,
    blocked_exec_view,
    blocked_panel_view,
    blocked_slab_view,
    blocked_spmm,
    blocked_spmm_panel,
    blocked_spmm_slab,
    blocked_spmm_slab_reference,
    blocked_spmm_xla,
)
from spmm_tpu_torch.ops.sddmm import sddmm, sddmm_values
from spmm_tpu_torch.ops.segments import boundary_segments
from spmm_tpu_torch.ops.transform import (
    add,
    col_sums,
    diagonal,
    row_sums,
    scale_cols,
    scale_rows,
    transpose,
)

# the production SpGEMM is the slab kernel, as in the JAX package; the
# global-sort ESC (spgemm_sorted) takes its heavy-tail rows
spgemm = spgemm_slab
#: the JAX package's name for the BSR oracle
bsr_spmm_xla = bsr_spmm_reference

__all__ = [
    "spmm",
    "spmv",
    "spmm_xla",
    "spmv_xla",
    "spgemm",
    "spgemm_slab",
    "spgemm_slab_device",
    "spgemm_slab_csr",
    "spgemm_slab_big",
    "spgemm_plan",
    "spgemm_plan_revalue",
    "spgemm_chain_device",
    "spgemm_sorted",
    "spgemm_coo_padded",
    "spgemm_expand_bound",
    "ell_spmm",
    "ell_spmv",
    "ell_slab_spmm",
    "ell_slab_spmm_reference",
    "ell_slabs_spmm",
    "ell_slabs_spmm_reference",
    "ell_slabs_spmm_transposed",
    "ell_slabs_spmm_transposed_reference",
    "ell_slabs_sddmm",
    "ell_slabs_sddmm_reference",
    "transposed_slabs",
    "bsr_spmm_transposed",
    "bsr_spmm_transposed_reference",
    "bsr_data_grad",
    "bsr_spmm",
    "bsr_spmm_reference",
    "bsr_spmm_xla",
    "bsr_spmv",
    "blocked_exec_view",
    "blocked_spmm_xla",
    "blocked_panel_view",
    "blocked_spmm_panel",
    "blocked_slab_view",
    "blocked_spmm_slab",
    "blocked_spmm_slab_reference",
    "blocked_chain_spmv",
    "blocked_spmm",
    "sddmm",
    "sddmm_values",
    "boundary_segments",
    "transpose",
    "add",
    "diagonal",
    "row_sums",
    "col_sums",
    "scale_rows",
    "scale_cols",
]
