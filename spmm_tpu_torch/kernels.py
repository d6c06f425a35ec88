"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source into one shared library with a plain C
interface, ``_build/libspmm_tpu_torch_kernels.so``, at the first CUDA launch:
one ``nvcc -c`` per source, all started together, then one link.  It is
rebuilt only when a source is newer than the library.  The library is
loaded with ctypes: every pointer and the stream pass as ``c_void_p``, and
every C entry returns ``cudaGetLastError()``, on which ``check`` raises.

Importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile

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
F32, BF16, F64, I32, I64, F16 = 0, 1, 2, 3, 4, 5

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


def build(force: bool = False, *, lib: str = LIB, defines: tuple = ()) -> str:
    """Compile ``csrc/*.cu`` into ``lib`` unless it is newer than every
    source and header: each source to an object by its own ``nvcc -c``, all
    in parallel, then one link.  ``defines``: extra ``-D`` flags (variants
    built side by side, as ``sweep_k2.py`` does).  Raises with nvcc's output
    when a compile fails."""
    srcs = sources()
    headers = glob.glob(os.path.join(CSRC, "*.cuh"))
    if os.path.exists(lib) and not force:
        if os.path.getmtime(lib) >= max(os.path.getmtime(s) for s in [*srcs, *headers]):
            return lib
    nv = nvcc()
    flags = [f for f in NVCC_FLAGS if f != "-shared"] + list(defines)
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(lib)) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        procs = [subprocess.Popen([nv, *flags, "-c", "-o", o, s], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for s, o in zip(srcs, objs)]
        failed = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                failed.append(f"{s}:\n{out}")
        if failed:
            raise RuntimeError("build failed: " + "\n".join(failed))
        return compile_if_stale(objs, lib, [nv, *NVCC_FLAGS], force=True)


def load(path: str) -> ctypes.CDLL:
    """A built kernel library with the C entries' argument types set."""
    so = ctypes.CDLL(path)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.bsr_spmm_launch.restype = I
    so.bsr_spmm_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, LL, I, P]
    so.bsr_spmm_t_launch.restype = I
    so.bsr_spmm_t_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, LL, I, I, I, P]
    so.ell_slabs_spmm_launch.restype = I
    so.ell_slabs_spmm_launch.argtypes = [P, P, LL, I, P, I, P, LL, LL, I, I, P, P, P]
    so.ell_slabs_sddmm_launch.restype = I
    so.ell_slabs_sddmm_launch.argtypes = [P, P, LL, P, P, P, I, P, LL, LL, I, I, P, P]
    so.segment_sum_launch.restype = I
    so.segment_sum_launch.argtypes = [P, P, P, P, P, I, LL, LL, LL, I, I, I, I, P]
    so.slab_fetch_launch.restype = I
    so.slab_fetch_launch.argtypes = [P, P, I, P, P, I, P, LL, LL, I, I, P, I, LL, I, I, P, P, P]
    so.slab_merge_launch.restype = I
    so.slab_merge_launch.argtypes = [P, P, I, P, P, I, P, LL, LL, I, I, P, I, I, I, I, LL, I, I, P, P, P, P]
    so.slab_compact_counts_launch.restype = I
    so.slab_compact_counts_launch.argtypes = [P, I, LL, LL, P, P]
    so.slab_compact_launch.restype = I
    so.slab_compact_launch.argtypes = [P, I, LL, P, LL, LL, I, I, P, P, P]
    so.cuda_error_string.restype = ctypes.c_char_p
    so.cuda_error_string.argtypes = [I]
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = load(build())
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
