"""Carry containers across from the JAX package and back.

``from_numpy`` takes any ``spmm_tpu`` container (``COO``, ``CSR``, ``BSR``,
``ELL``, ``BlockedCSR``) and builds the same-named container of this package,
reading each field by name through ``np.asarray``.  It duck-types on the class
name and field names, so this package never imports ``spmm_tpu`` (which would
import JAX).  ``to_numpy`` is the inverse: it builds the containers of a given
namespace (for example the ``spmm_tpu.formats`` module, which the caller
imports) with numpy leaves, or this package's own containers when no namespace
is given.  Every leaf keeps its dtype both ways -- fp64 values stay fp64 (with
``jax.enable_x64`` on the JAX side), there is no down-cast to fp32 -- so the
parity tests feed both packages the same ``CSR``, ``ELL``, ``BSR`` and
``BlockedCSR``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmm_tpu_torch.formats.bsr import BSR
from spmm_tpu_torch.formats.containers import COO, CSR, BlockedCSR, as_numpy, is_array
from spmm_tpu_torch.formats.ell import ELL

_TYPES = {cls.__name__: cls for cls in (COO, CSR, BSR, ELL, BlockedCSR)}


def _leaf(x):
    """One field value: arrays (any framework) become writable numpy copies,
    tuples of arrays stay tuples, containers recurse, statics pass through."""
    if type(x).__name__ in _TYPES:
        return from_numpy(x)
    if isinstance(x, tuple):
        if x and not all(isinstance(v, (int, np.integer)) for v in x):
            return tuple(_leaf(v) for v in x)
        return tuple(int(v) for v in x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return np.array(x, copy=True)


def from_numpy(obj):
    """A JAX-package container (or one of this package's) → this package's
    container of the same name with numpy leaves."""
    name = type(obj).__name__
    if name not in _TYPES:
        raise TypeError(f"not a sparse container: {name}")
    cls = _TYPES[name]
    return cls(**{f.name: _leaf(getattr(obj, f.name)) for f in dataclasses.fields(cls)})


def to_numpy(obj, namespace=None):
    """This package's container → numpy leaves, as an instance of
    ``getattr(namespace, <class name>)`` when ``namespace`` is given (nested
    containers too), else of this package's own class."""
    if not (dataclasses.is_dataclass(obj) and type(obj).__name__ in _TYPES):
        raise TypeError(f"not a sparse container: {type(obj).__name__}")

    def conv(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return to_numpy(x, namespace)
        if isinstance(x, tuple) and x and all(is_array(a) for a in x):
            return tuple(as_numpy(a) for a in x)
        return as_numpy(x) if is_array(x) else x

    cls = type(obj) if namespace is None else getattr(namespace, type(obj).__name__)
    return cls(**{f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
