from spmm_tpu_torch.ops.spmm import spmm, spmv, spmm_xla, spmv_xla
from spmm_tpu_torch.ops.spgemm import spgemm_sorted, spgemm_coo_padded, spgemm_expand_bound
from spmm_tpu_torch.ops.ell_spmm import ell_spmm, ell_spmv
from spmm_tpu_torch.ops.ell_kernel import ell_slab_spmm, ell_slab_spmm_reference
from spmm_tpu_torch.ops.bsr_kernel import bsr_spmm, bsr_spmm_reference
from spmm_tpu_torch.ops.segments import boundary_segments

# the JAX package binds ``spgemm`` to its slab kernel (ops/slab_spgemm.py);
# until that is ported, the exact global-sort ESC is the port's SpGEMM
spgemm = spgemm_sorted
#: the JAX package's name for the BSR oracle
bsr_spmm_xla = bsr_spmm_reference

__all__ = [
    "spmm",
    "spmv",
    "spmm_xla",
    "spmv_xla",
    "spgemm",
    "spgemm_sorted",
    "spgemm_coo_padded",
    "spgemm_expand_bound",
    "ell_spmm",
    "ell_spmv",
    "ell_slab_spmm",
    "ell_slab_spmm_reference",
    "bsr_spmm",
    "bsr_spmm_reference",
    "bsr_spmm_xla",
    "boundary_segments",
]
