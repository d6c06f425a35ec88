from spmm_tpu_torch.parallel.mesh import make_mesh
from spmm_tpu_torch.parallel.partition import (
    ColShardedCSR,
    ShardedCSR,
    partition_cols,
    partition_rows,
    unshard_csr_rows,
    unshard_rows,
)
from spmm_tpu_torch.parallel.spmm_dist import (
    spmm_dist,
    spmm_dist_colsplit,
    spmm_dist_ring,
    spmv_dist,
)
from spmm_tpu_torch.parallel.spgemm_spmd import (
    spgemm_dist_big,
    spgemm_dist_csr,
    spgemm_dist_exec,
    spgemm_dist_halo,
    spgemm_dist_halo_exchange,
    spgemm_dist_plan,
    spgemm_dist_revalue,
    spgemm_dist_spmd,
)

__all__ = [
    "make_mesh",
    "ColShardedCSR",
    "ShardedCSR",
    "partition_cols",
    "partition_rows",
    "unshard_csr_rows",
    "unshard_rows",
    "spmm_dist",
    "spmm_dist_colsplit",
    "spmm_dist_ring",
    "spmv_dist",
    "spgemm_dist_big",
    "spgemm_dist_csr",
    "spgemm_dist_exec",
    "spgemm_dist_plan",
    "spgemm_dist_revalue",
    "spgemm_dist_halo",
    "spgemm_dist_halo_exchange",
    "spgemm_dist_spmd",
]
