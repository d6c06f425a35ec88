"""Deterministic synthetic sparse matrices (port of
``spmm_tpu/formats/synthetic.py``: numpy only, so the same seed gives the
bit-identical matrix in both packages).

The reference evaluates on SuiteSparse web graphs (web-Stanford, web-Google,
sx-askubuntu — reference README.md:12-18, matrix.txt:1).  Benchmarks and tests
generate structurally similar synthetic graphs instead of downloading them:
square, power-law degree distribution, mixed local/global column targets (web
graphs have strong host-locality — runs of nearby columns — which is exactly
what the bitmap dominant-section reorder exploits).
"""

from __future__ import annotations

import numpy as np

from spmm_tpu_torch.formats.containers import COO, CSR, to_csr


def webgraph_like(
    n: int,
    nnz: int,
    *,
    seed: int = 0,
    locality: float = 0.6,
    zipf_a: float = 2.72,
    empty_frac: float = 0.044,
    dtype=np.float32,
    match_nnz: bool = True,
) -> CSR:
    """Square web-graph-like matrix: power-law row degrees; a ``locality``
    fraction of each row's targets are near the diagonal (same 2048-column
    section), the rest hit popular global columns (zipf).

    Parameters are calibrated against published web-graph statistics
    (benchmarks/validate_synthetic.py; report in BASELINE.md):
    ``zipf_a=2.72`` is the web out-degree power-law exponent (Broder et al.
    2000) — multiplicative rescaling to the target density preserves it;
    ``empty_frac=0.044`` is the SuiteSparse web-Google id-space gap
    (916,428 ids vs 875,713 connected nodes — absent ids are all-zero rows);
    the in-degree tail (zipf 1.3 popularity mix) lands at Hill α≈2.0-2.3,
    matching the published 2.1.  ``match_nnz``: duplicate synthetic edges
    collapse on dedup, so edge generation is topped up until the simple
    graph's nnz is within 0.5% of the request — the synthetic then carries
    the same edge count as the real graph it stands in for."""
    rng = np.random.default_rng(seed)
    # power-law out-degrees normalized to hit ~nnz (scale-free: multiplying
    # preserves the tail exponent); cap near web-Google's max out-degree 456
    deg = _zipf(rng, zipf_a, n)
    deg = np.minimum(deg, 512)
    scale = nnz / max(1, deg.sum())
    deg = np.maximum(1, (deg * scale)).astype(np.int64)
    deg = np.minimum(deg, 512)
    if empty_frac > 0.0:  # dangling/absent pages: all-zero rows
        deg[rng.random(n) < empty_frac] = 0
        nz = max(1, int(deg.sum()))
        deg = np.maximum((deg * (nnz / nz)), deg.astype(bool)).astype(np.int64)
    total = int(deg.sum())
    row = np.repeat(np.arange(n, dtype=np.int64), deg)

    def targets(row, rng):
        total = len(row)
        local = rng.random(total) < locality
        # local targets: same section as the row (web-host locality)
        sect = (row // 2048) * 2048
        local_col = sect + rng.integers(0, 2048, size=total)
        # global targets: popular columns (zipf rank → column id, hashed spread)
        rank = np.minimum(_zipf(rng, 1.3, total), n) - 1
        glob_col = (rank * 2654435761) % n
        col = np.where(local, local_col, glob_col)
        return np.minimum(col, n - 1)

    col = targets(row, rng)
    # real web graphs are simple (no multi-edges): duplicate synthetic edges
    # collapse to a single unit entry, matching the reference ingest's
    # forced-1.0 pattern semantics (serial_newblock_clock.cpp:84,96)
    keys = None  # the distinct edges, row-major: row * n + col ascending
    for _ in range(4):
        keys = _distinct(row * n + col)
        missing = nnz - len(keys)
        if not match_nnz or missing <= max(2, nnz // 200):
            break
        # top-up: extra edges from rows sampled ∝ degree (tail stays put)
        extra_row = row[rng.integers(0, len(row), size=int(missing * 1.15))]
        extra_col = targets(extra_row, rng)
        row = np.concatenate([row, extra_row])
        col = np.concatenate([col, extra_col])
        keys = None
    if keys is None:
        keys = _distinct(row * n + col)
    # one unit entry per distinct edge, columns ascending in each row: what
    # ``to_csr(sort_within_row=True, sum_duplicates=True)`` of the edges with
    # the values then set to 1 gives, without its two-key sort
    rows = keys // n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSR(
        data=np.ones(len(keys), dtype=dtype), indices=(keys - rows * n).astype(np.int32),
        indptr=indptr.astype(np.int32), shape=(n, n), nnz=len(keys),
    )


def _distinct(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by one sort: numpy 2.3's ``unique`` goes through a
    hash table first, which made a 10^8-edge graph take minutes."""
    keys = np.sort(keys)
    new = np.empty(len(keys), dtype=bool)
    new[:1] = True
    np.not_equal(keys[1:], keys[:-1], out=new[1:])
    return keys[new]


#: ``float(INT64_MAX)``: a Zipf try above it is rejected, as numpy does
_ZIPF_MAX = float(np.iinfo(np.int64).max)


def _zipf(rng: np.random.Generator, a: float, size: int, block: int = 1 << 22) -> np.ndarray:
    """``rng.zipf(a, size)`` (int64) as numpy 2.0's ``Generator`` draws it,
    made from the generator's own doubles, so that a seed gives the same
    graph whatever numpy's version: ``Generator.zipf``'s algorithm changed
    after 2.0, and numpy 2.3 gives another graph for the same seed.

    Each try takes two doubles, U = 1 - u and V; X = floor(U^(-1 / (a - 1)))
    is kept when 1 <= X <= INT64_MAX and V·X·(T - 1) / (b - 1) <= T / b,
    with T = (1 + 1/X)^(a - 1) and b = 2^(a - 1).  The tries are made
    ``block`` samples at a time; the generator is then wound back and moved
    on by exactly the doubles that the kept tries used.  ``np.power`` may
    differ from the C library's ``pow`` in the last bit, which moves only
    X past 2^50 (every caller clips X far below that)."""
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
        if len(kept) >= need:  # wind back, then use the doubles of tries 0 .. the last kept one
            rng.bit_generator.state = state
            rng.random(2 * (int(kept[need - 1]) + 1))
            kept = kept[:need]
        out[filled : filled + len(kept)] = X[kept]
        filled += len(kept)
    return out


def rmat_matrix(
    scale: int, edge_factor: int = 16, *, seed: int = 0, a=0.57, b=0.19, c=0.19, dtype=np.float32
) -> CSR:
    """Graph500-style RMAT generator (vectorized bit-recursion)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    row = np.zeros(m, dtype=np.int64)
    col = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for bit in range(scale):
        r_bit = rng.random(m) > ab
        c_bit = np.where(r_bit, rng.random(m) > c_norm, rng.random(m) > a_norm)
        row |= r_bit.astype(np.int64) << bit
        col |= c_bit.astype(np.int64) << bit
    dat = np.ones(m, dtype=dtype)
    coo = COO(row=row.astype(np.int32), col=col.astype(np.int32), data=dat, shape=(n, n), nnz=m)
    return to_csr(coo, sort_within_row=True, sum_duplicates=True)


def banded_random(n: int, band: int, density: float, *, seed: int = 0, dtype=np.float32) -> CSR:
    """Random matrix with nonzeros confined to a diagonal band — exercises the
    region splitter and panelizer with a bounded working set."""
    rng = np.random.default_rng(seed)
    per_row = max(1, int(band * density))
    row = np.repeat(np.arange(n, dtype=np.int64), per_row)
    off = rng.integers(-band // 2, band // 2 + 1, size=n * per_row)
    col = np.clip(row + off, 0, n - 1)
    dat = rng.standard_normal(n * per_row).astype(dtype)
    coo = COO(row=row.astype(np.int32), col=col.astype(np.int32), data=dat, shape=(n, n), nnz=len(row))
    return to_csr(coo, sort_within_row=True, sum_duplicates=True)


def random_csr(nrow: int, ncol: int, density: float, *, seed: int = 0, dtype=np.float32) -> CSR:
    """Uniform random sparse matrix with real values (general, non-square OK)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(nrow * ncol * density))
    row = rng.integers(0, nrow, size=nnz).astype(np.int32)
    col = rng.integers(0, ncol, size=nnz).astype(np.int32)
    dat = rng.standard_normal(nnz).astype(dtype)
    coo = COO(row=row, col=col, data=dat, shape=(nrow, ncol), nnz=nnz)
    return to_csr(coo, sort_within_row=True, sum_duplicates=True)
