"""An undirected graph with one power-law degree law, stored both ways.

For a configuration whose public graph is undirected (a co-purchase or
social graph) and whose files cannot be had: the node and edge counts are
the published ones, the degree law is the configuration's assumption.  Plain
numpy, nothing of the program; every draw is taken from the generator's own
doubles, so a seed gives the same graph under every numpy.
"""

from __future__ import annotations

import numpy as np

from portbench.gen.webgraph import _distinct


def undirected_powerlaw(n: int, nnz: int, *, seed: int, gamma: float = 2.5, max_degree: int = 16384):
    """``(indptr, indices)`` of a symmetric n × n pattern of about ``nnz``
    entries (``nnz // 2`` undirected pairs, each stored as (i, j) and
    (j, i)), int32, columns ascending in each row, no self-loop and no
    duplicate.  Each node has a weight drawn from one power law, P(w) ∝
    w^-``gamma`` (a Pareto by inversion, rounded), scaled so that the weights
    sum to ``nnz`` and capped at ``max_degree``; both endpoints of every pair
    are drawn in proportion to the weights (a node's stubs picked at random),
    so a node's expected degree is its weight, in its row and in its column
    alike, and nodes are numbered at random (no locality).  Pairs lost to
    self-loops and repeats are drawn again until the distinct pairs are
    within 0.5% of ``nnz // 2``."""
    rng = np.random.default_rng(seed)
    x = np.power(1.0 - rng.random(n), -1.0 / (gamma - 1.0))
    scale = nnz / x.sum()
    for _ in range(32):  # the floor and the cap move the sum: scale again until it holds
        w = np.minimum(np.maximum(1.0, np.rint(x * scale)), max_degree)
        if abs(w.sum() - nnz) <= 1:
            break
        scale *= nnz / w.sum()
    stubs = np.repeat(np.arange(n, dtype=np.int32), w.astype(np.int64))
    want = nnz // 2

    def ends(pairs):
        pick = (rng.random(2 * pairs) * len(stubs)).astype(np.int64)
        return stubs[pick[0::2]].astype(np.int64), stubs[pick[1::2]].astype(np.int64)

    a, b = ends(want)
    keys = None  # the distinct pairs, lo * n + hi with lo < hi, ascending
    for _ in range(4):
        live = a != b
        keys = _distinct(np.minimum(a, b)[live] * n + np.maximum(a, b)[live])
        missing = want - len(keys)
        if missing <= max(2, want // 200):
            break
        ea, eb = ends(int(missing * 1.15))
        a, b = np.concatenate([a, ea]), np.concatenate([b, eb])
    lo, hi = np.divmod(keys, n)
    both = np.concatenate([keys, hi * n + lo])
    both.sort()
    rows = both // n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr.astype(np.int32), (both - rows * n).astype(np.int32)
