from spmm_tpu_torch.parallel.partition import ShardedCSR, partition_rows

__all__ = ["ShardedCSR", "partition_rows"]
