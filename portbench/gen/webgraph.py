"""The benchmark's frozen copy of the web-graph generator.

A copy of ``webgraph_like`` with ``_zipf`` and ``_distinct`` as they stood
when the benchmark was written (the program's ``formats/synthetic.py``),
calibrated to SNAP's web-Google and web-Stanford statistics (BASELINE.md).
It returns plain numpy arrays and imports nothing of the program, so a later
change to the program's generator cannot change the benchmark's graphs.  A
seed gives the same graph under every numpy: the Zipf draws are numpy 2.0's
algorithm on the generator's own doubles.
"""

from __future__ import annotations

import numpy as np


def webgraph_like(n: int, nnz: int, *, seed: int, locality: float = 0.6, zipf_a: float = 2.72,
                  empty_frac: float = 0.044, match_nnz: bool = True):
    """``(indptr, indices)`` of a square web-graph-like pattern, int32, columns
    ascending in each row, no duplicate entry: power-law row degrees; a
    ``locality`` fraction of each row's targets lie in its own 2048-column
    section, the rest hit popular columns (Zipf 1.3); an ``empty_frac`` of
    the rows are empty; edges are topped up until the distinct count is
    within 0.5% of ``nnz``."""
    rng = np.random.default_rng(seed)
    deg = _zipf(rng, zipf_a, n)
    deg = np.minimum(deg, 512)
    scale = nnz / max(1, deg.sum())
    deg = np.maximum(1, (deg * scale)).astype(np.int64)
    deg = np.minimum(deg, 512)
    if empty_frac > 0.0:
        deg[rng.random(n) < empty_frac] = 0
        nz = max(1, int(deg.sum()))
        deg = np.maximum((deg * (nnz / nz)), deg.astype(bool)).astype(np.int64)
    row = np.repeat(np.arange(n, dtype=np.int64), deg)

    def targets(row, rng):
        total = len(row)
        local = rng.random(total) < locality
        sect = (row // 2048) * 2048
        local_col = sect + rng.integers(0, 2048, size=total)
        rank = np.minimum(_zipf(rng, 1.3, total), n) - 1
        glob_col = (rank * 2654435761) % n
        col = np.where(local, local_col, glob_col)
        return np.minimum(col, n - 1)

    col = targets(row, rng)
    keys = None  # the distinct edges, row-major: row * n + col ascending
    for _ in range(4):
        keys = _distinct(row * n + col)
        missing = nnz - len(keys)
        if not match_nnz or missing <= max(2, nnz // 200):
            break
        extra_row = row[rng.integers(0, len(row), size=int(missing * 1.15))]
        extra_col = targets(extra_row, rng)
        row = np.concatenate([row, extra_row])
        col = np.concatenate([col, extra_col])
        keys = None
    if keys is None:
        keys = _distinct(row * n + col)
    rows = keys // n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr.astype(np.int32), (keys - rows * n).astype(np.int32)


def _distinct(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by one sort."""
    keys = np.sort(keys)
    new = np.empty(len(keys), dtype=bool)
    new[:1] = True
    np.not_equal(keys[1:], keys[:-1], out=new[1:])
    return keys[new]


_ZIPF_MAX = float(np.iinfo(np.int64).max)


def _zipf(rng: np.random.Generator, a: float, size: int, block: int = 1 << 22) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0's ``Generator`` draws it, from the
    generator's own doubles: each try takes U = 1 - u and V, X =
    floor(U^(-1 / (a - 1))) is kept when 1 <= X <= INT64_MAX and
    V·X·(T - 1) / (b - 1) <= T / b, with T = (1 + 1/X)^(a - 1) and
    b = 2^(a - 1); the generator is then wound back and moved on by exactly
    the doubles that the kept tries used."""
    am1 = a - 1.0
    b = 2.0**am1
    out = np.empty(size, np.int64)
    filled = 0
    while filled < size:
        need = min(size - filled, block)
        tries = int(need * 1.25) + 64
        state = rng.bit_generator.state
        u = rng.random(2 * tries)
        U, V = 1.0 - u[0::2], u[1::2]
        X = np.floor(np.power(U, -1.0 / am1))
        ok = (X <= _ZIPF_MAX) & (X >= 1.0)
        Xs = np.where(ok, X, 1.0)
        T = np.power(1.0 + 1.0 / Xs, am1)
        kept = np.flatnonzero(ok & (V * Xs * (T - 1.0) / (b - 1.0) <= T / b))
        if len(kept) >= need:
            rng.bit_generator.state = state
            rng.random(2 * (int(kept[need - 1]) + 1))
            kept = kept[:need]
        out[filled : filled + len(kept)] = X[kept]
        filled += len(kept)
    return out
