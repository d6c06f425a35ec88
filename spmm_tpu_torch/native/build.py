"""Build the native host library (g++ → ``_build/libspmm_native.so``).

The C++ sources, ``mtxparse.cpp`` and ``preprocess.cpp`` beside this file
(plain C interfaces), are this package's own copies of the JAX package's
``spmm_tpu/native/`` sources, byte for byte, so both packages read .mtx
files and build the packed format with one definition
(``tests/test_torch_formats.py`` holds the copies equal).  The library is
built into this package's ``_build/`` directory, never beside the sources.

Lazy build on first use; rebuilt only when a source is newer than the
library.  Concurrent builders write to a temp file and rename atomically.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCES = tuple(os.path.join(_HERE, f) for f in ("mtxparse.cpp", "preprocess.cpp"))
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libspmm_native.so")


def compile_if_stale(
    srcs: list[str], lib: str, cmd: list[str], *, headers: list[str] = (), force: bool = False
) -> str:
    """Run ``cmd + ["-o", tmp] + srcs`` and move ``tmp`` to ``lib``, unless
    ``lib`` is newer than every source and header.  Raises with the
    compiler's output when the compile fails."""
    if os.path.exists(lib) and not force:
        if os.path.getmtime(lib) >= max(os.path.getmtime(s) for s in [*srcs, *headers]):
            return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    full = [*cmd, "-o", tmp, *srcs]
    try:
        res = subprocess.run(full, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"build failed: {' '.join(full)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def sources() -> list[str] | None:
    """Paths of the C++ sources, or None when an installation lacks them."""
    return list(SOURCES) if all(os.path.exists(s) for s in SOURCES) else None


def build(force: bool = False) -> str | None:
    """Returns the library path, or None when there is nothing to build with
    (no sources, or no g++ and no library built before)."""
    srcs = sources()
    if srcs is None:
        return None
    if shutil.which("g++") is None:
        return LIB if os.path.exists(LIB) and not force else None
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-march=native"]
    return compile_if_stale(srcs, LIB, cmd, force=force)


if __name__ == "__main__":
    print(build(force=True))
