"""The port's native C++ helpers against their numpy fallbacks and the JAX
package's native results: mirrors ``tests/test_native.py`` case by case
(parse, region split, dominant sections, first-touch relabel)."""

import numpy as np

from spmm_tpu import native as jnative
from spmm_tpu.formats.synthetic import webgraph_like as j_webgraph_like
from spmm_tpu.preprocess import regions as jregions
from spmm_tpu.preprocess import reorder as jreorder

from spmm_tpu_torch import native
from spmm_tpu_torch.formats import mtx as tmtx
from spmm_tpu_torch.formats.synthetic import webgraph_like
from spmm_tpu_torch.preprocess import regions, reorder

from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def test_parse_matches_numpy():
    body = b"3 1 7.5e-2\n1 2 -4\n2 2 1.25\n"
    t = native.parse_coordinate_body(body, 3, 3)
    np.testing.assert_allclose(t, [[3, 1, 0.075], [1, 2, -4.0], [2, 2, 1.25]])
    np.testing.assert_array_equal(t, tmtx._numpy_parse(body, 3, 3))
    np.testing.assert_array_equal(t, jnative.parse_coordinate_body(body, 3, 3))


def test_region_split_native_vs_numpy(monkeypatch):
    A = webgraph_like(2000, 14000, seed=0)
    got = regions.split_regions(A, 300)
    np.testing.assert_array_equal(got, jregions.split_regions(j_webgraph_like(2000, 14000, seed=0), 300))
    monkeypatch.setattr(native, "region_split", lambda *a, **k: None)  # the numpy fallback
    np.testing.assert_array_equal(got, regions.split_regions(A, 300))


def test_dominant_sections_native_vs_numpy(monkeypatch):
    A = webgraph_like(1500, 9000, seed=1)
    got = reorder.dominant_sections(A, 512)
    np.testing.assert_array_equal(got, jreorder.dominant_sections(j_webgraph_like(1500, 9000, seed=1), 512))
    monkeypatch.setattr(native, "dominant_sections", lambda *a, **k: None)
    np.testing.assert_array_equal(got, reorder.dominant_sections(A, 512))


def test_relabel_native_vs_numpy():
    rng = np.random.default_rng(2)
    nnz, ncol = 5000, 700
    cols = rng.integers(0, ncol, nnz).astype(np.int32)
    region_nnz = np.array([0, 1200, 1200, 3777, nnz], dtype=np.int64)  # an empty region too
    codes, gather, counts = native.relabel_first_touch(cols, region_nnz, ncol)
    # oracle: a dict per region
    exp_codes = np.empty(nnz, dtype=np.int64)
    exp_gather, exp_counts = [], []
    for lo, hi in zip(region_nnz[:-1], region_nnz[1:]):
        seen = {}
        for p in range(lo, hi):
            c = int(cols[p])
            if c not in seen:
                seen[c] = len(seen)
                exp_gather.append(c)
            exp_codes[p] = seen[c]
        exp_counts.append(len(seen))
    np.testing.assert_array_equal(codes, exp_codes)
    np.testing.assert_array_equal(gather, exp_gather)
    np.testing.assert_array_equal(counts, exp_counts)
    for u, v in zip((codes, gather, counts), jnative.relabel_first_touch(cols, region_nnz, ncol)):
        np.testing.assert_array_equal(u, v)
