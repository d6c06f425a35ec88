"""spmm_tpu_torch — the PyTorch/CUDA port of ``spmm_tpu``, for NVIDIA Hopper.

Same module layout and public names as the JAX package, which stays the
reference the port is tested against:

- ``formats``    — COO / CSR / BSR / ELL / BlockedCSR containers (numpy on the
                   host, torch tensors on a device) + .mtx ingest + generators
- ``preprocess`` — the reference's locality pipeline (host numpy + the shared
                   native C++ passes; the bitmap reorder also on the device)
- ``ops``        — SpMM / SpMV (hand-written CUDA kernels K1 = BSR, K2 = ELL
                   slab, with plain PyTorch versions on the CPU) over ELL,
                   BSR, CSR and the packed BlockedCSR (K2 per v8-group
                   bucket), differentiable (K2 / K1 on the transposed
                   structure, K3 = the slab values' gradient) and in fp32
                   or fp64 (``accum_dtype``); SDDMM, the datasheet
                   roofline, exact SpGEMM (the slab-sorted
                   ``ops.spgemm`` with plans, the streamed big path and
                   checkpoints; the global-sort ESC for heavy rows) and
                   sparse transforms
- ``entry``      — the single-chip forward step (blocked SpMM of the
                   preprocessed format), as the JAX package's ``entry()``
- ``parallel``   — row partitioning (``partition_rows``) and the uniform
                   chunk schedule of row pieces
- ``utils``      — ``serialize.save`` / ``load`` (.npz, readable by both
                   packages), ``timing.measure`` (CUDA events),
                   ``profiling.profile_fn`` (``torch.profiler``) and
                   ``profiling.span`` (the ``spmm.*`` spans)
- ``kernels``    — nvcc build + ctypes binding of ``csrc/*.cu``

This package imports torch and numpy, never JAX or ``spmm_tpu``.
"""

from spmm_tpu_torch.config import Config, default_config
from spmm_tpu_torch.formats import COO, CSR, BlockedCSR, read_mtx, to_coo, to_csr
from spmm_tpu_torch import ops

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "BlockedCSR",
    "Config",
    "default_config",
    "read_mtx",
    "to_csr",
    "to_coo",
    "ops",
]
