"""Shared helper of the ``test_torch_*`` files: field-by-field equality of
two sparse containers, from either package, with numpy or torch leaves."""

import dataclasses

import numpy as np
import pytest
import torch

from spmm_tpu_torch.formats import containers as tc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a test module that imports this fixture.  The
    tier-1 run puts six pytest-xdist workers on the CPU's cores; with its own
    pool of a thread per core, each worker's many small torch ops wait on
    threads that do not get a core (the 1,024-piece big-path test: 44 s with
    8 threads against 1.5 s with one, beside 7 busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(a, b):
    """Field-by-field equality of two containers (any package, any leaves)."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            assert_same(x, y)
        elif isinstance(x, tuple) and x and not isinstance(x[0], (int, np.integer)):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                np.testing.assert_array_equal(tc.as_numpy(u), tc.as_numpy(v), err_msg=f.name)
        elif tc.is_array(x) or hasattr(x, "shape") and not isinstance(x, tuple):
            u, v = np.asarray(tc.as_numpy(x)), np.asarray(tc.as_numpy(y))
            assert u.dtype == v.dtype, (f.name, u.dtype, v.dtype)
            np.testing.assert_array_equal(u, v, err_msg=f.name)
        else:
            assert tuple(x) == tuple(y) if isinstance(x, tuple) else x == y, f.name


def rhs(n, k, seed):
    """A seeded (n, k) fp32 dense operand."""
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


#: the sizing's cases, each run on the CPU against the JAX package and on the card against the CPU
SIZING_CASES = ("rectangular", "tail", "overflow", "bad_index")


def sizing_case(name):
    """(A, B, W, classes, the ``_MAX_EXP_PAD`` to set or None, the error
    the sizing raises or None) of a sizing case: a rectangular product with
    empty rows in A and in B (W 4, the default classes, small classes
    folded); a row above the class ceiling (W 8, the default classes); the
    same over a budget cut to 4,096 slots (``_ExpansionTooLarge``); a column
    index of A that is not a row of B (ValueError)."""
    import scipy.sparse as sp

    from spmm_tpu_torch.formats import CSR
    from spmm_tpu_torch.ops import slab_spgemm as ss

    def emptied(M, every):
        keep = np.ones(M.shape[0])
        keep[::every] = 0
        return sp.diags(keep) @ M

    if name == "rectangular":
        A = emptied(sp.random(1500, 900, density=0.008, random_state=31, format="csr"), 7)
        B = emptied(sp.random(900, 700, density=0.02, random_state=32, format="csr"), 5)
        A, B = CSR.from_scipy(A, np.float32), CSR.from_scipy(B, np.float32)
        return A, B, 4, ss._norm_classes(ss.DEFAULT_CLASSES, 4), None, None
    rng = np.random.default_rng(21)
    A = sp.random(900, 900, density=0.015, random_state=21, format="lil", dtype=np.float32)
    A[7, :] = rng.standard_normal(900)
    A = CSR.from_scipy(A.tocsr())
    classes = ss._norm_classes(ss.DEFAULT_CLASSES, 8)
    if name == "tail":
        return A, A, 8, classes, None, None
    if name == "overflow":
        return A, A, 8, classes, 4096, ss._ExpansionTooLarge
    if name == "bad_index":  # B holds only A's first 600 rows
        Bs = A.to_scipy()[:600]
        return A, CSR.from_scipy(Bs), 8, classes, None, ValueError
    raise KeyError(name)
