"""spmm_tpu_torch — the PyTorch/CUDA port of ``spmm_tpu``, for NVIDIA Hopper.

Same module layout and public names as the JAX package, which stays the
reference the port is tested against:

- ``formats``    — COO / CSR / BSR / ELL / BlockedCSR containers (numpy on the
                   host, torch tensors on a device) + .mtx ingest + generators
- ``preprocess`` — the reference's locality pipeline (host numpy + the shared
                   native C++ passes)
- ``ops``        — SpMM / SpMV (hand-written CUDA kernels K1 = BSR, K2 = ELL
                   slab, with plain PyTorch versions on the CPU) and exact
                   SpGEMM (global-sort ESC in torch)
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
