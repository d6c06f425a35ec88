"""The frozen generator against BASELINE.md's counts, without the program's
generator."""

import numpy as np
import scipy.sparse as sp

from portbench.gen import make_graph
from portbench.gen.webgraph import webgraph_like


def test_web_google_seed_0_matches_the_recorded_counts():
    indptr, indices = webgraph_like(916_428, 5_105_039, seed=0)
    assert int(indptr[-1]) == 5_124_525
    A = sp.csr_matrix((np.ones(len(indices), np.float32), indices, indptr), shape=(916_428, 916_428))
    assert (A @ A).nnz == 25_298_715


def test_graph_is_a_canonical_csr_and_repeats_from_its_seed():
    a = webgraph_like(5000, 30_000, seed=2**31 + 11)
    b = webgraph_like(5000, 30_000, seed=2**31 + 11)
    indptr, indices = a
    assert indptr.dtype == indices.dtype == np.int32
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert abs(int(indptr[-1]) - 30_000) <= 30_000 // 200 + 2
    for r in range(len(indptr) - 1):
        row = indices[indptr[r] : indptr[r + 1]]
        assert np.all(np.diff(row) > 0)
    assert not np.array_equal(webgraph_like(5000, 30_000, seed=12)[1][:100], indices[:100])


def test_the_seed_draws_the_values_and_the_configuration_the_structure():
    cfg = {"generator": {"name": "webgraph_like", "n": 2000, "nnz": 12_000, "seed": 4}, "dtype": "float32"}
    g = make_graph(cfg, 3, "normal")
    assert g.data.dtype == np.float32 and g.data.std() > 0.5
    assert np.array_equal(g.data, make_graph(cfg, 3, "normal").data)
    other = make_graph(cfg, 2**31 + 9, "normal")
    assert np.array_equal(other.indices, g.indices) and not np.array_equal(other.data, g.data)
    assert np.array_equal(g.indptr, webgraph_like(2000, 12_000, seed=4)[0])
    assert np.all(make_graph(cfg, 3, "ones").data == 1)
