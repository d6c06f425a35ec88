"""Shared helper of the ``test_torch_*`` files: field-by-field equality of
two sparse containers, from either package, with numpy or torch leaves."""

import dataclasses

import numpy as np

from spmm_tpu_torch.formats import containers as tc


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
