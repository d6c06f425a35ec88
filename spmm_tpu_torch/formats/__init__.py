from spmm_tpu_torch.formats.containers import COO, CSR, BlockedCSR, permute_rows, to_coo, to_csr
from spmm_tpu_torch.formats.bsr import BSR, csr_to_bsr
from spmm_tpu_torch.formats.ell import ELL, ell_pack, ell_pack_device
from spmm_tpu_torch.formats.mtx import read_mtx, read_mtx_csr, write_mtx
from spmm_tpu_torch.formats.synthetic import banded_random, random_csr, rmat_matrix, webgraph_like
from spmm_tpu_torch.formats.convert import from_numpy, to_numpy

__all__ = [
    "COO",
    "CSR",
    "BSR",
    "ELL",
    "BlockedCSR",
    "to_coo",
    "to_csr",
    "permute_rows",
    "csr_to_bsr",
    "ell_pack",
    "ell_pack_device",
    "read_mtx",
    "read_mtx_csr",
    "write_mtx",
    "rmat_matrix",
    "webgraph_like",
    "banded_random",
    "random_csr",
    "from_numpy",
    "to_numpy",
]
