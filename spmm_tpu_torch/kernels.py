"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source into one shared library with a plain C
interface, ``_build/libspmm_tpu_torch_kernels.so``, at the first CUDA launch;
it is rebuilt only when a source is newer than the library.  The library is
loaded with ctypes: every pointer and the stream pass as ``c_void_p``, and
every C entry returns ``cudaGetLastError()``, on which ``check`` raises.

Importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil

import torch

from spmm_tpu_torch.native.build import compile_if_stale

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
LIB = os.path.join(_HERE, "_build", "libspmm_tpu_torch_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# dtype codes of the C entries
F32, BF16 = 0, 1

_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def build(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into ``LIB`` unless it is newer than every
    source and header.  Raises with nvcc's output when the compile fails."""
    headers = glob.glob(os.path.join(CSRC, "*.cuh"))
    return compile_if_stale(sources(), LIB, [nvcc(), *NVCC_FLAGS], headers=headers, force=force)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(build())
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        so.bsr_spmm_launch.restype = I
        so.bsr_spmm_launch.argtypes = [P, P, P, P, P, I, I, I, I, LL, I, P]
        so.ell_slab_spmm_launch.restype = I
        so.ell_slab_spmm_launch.argtypes = [P, P, I, P, I, P, LL, I, LL, LL, P]
        so.cuda_error_string.restype = ctypes.c_char_p
        so.cuda_error_string.argtypes = [I]
        _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib().cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


if __name__ == "__main__":
    print(build(force=True))
