"""Serialization of sparse containers to one ``.npz`` each (port of
``spmm_tpu/utils/serialize.py``).

The reference computes its packed format and then drops it (SURVEY.md §2.7,
§5 "checkpoint/resume: none"); here every container round-trips, so a
preprocessing is reusable across runs.  The file layout is the JAX
package's: one array per array field (torch tensors are written as numpy),
tuples of arrays as ``<field>__<i>`` with their length in the JSON
``__meta``, nested containers under ``<field>.``.  So a COO, CSR, BSR,
BlockedCSR or ELL written by either package loads in the other.

A ``SpgemmPlan`` is saved too, in this package's own layout (the JAX plan
keeps TPU-folded tables); loading a JAX plan raises ValueError.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from spmm_tpu_torch.formats.bsr import BSR
from spmm_tpu_torch.formats.containers import COO, CSR, BlockedCSR, as_numpy, is_array
from spmm_tpu_torch.formats.ell import ELL

_TYPES = {c.__name__: c for c in (COO, CSR, BSR, BlockedCSR, ELL)}

#: ``__layout`` of the plans this package writes
_PLAN_LAYOUT = "spmm_tpu_torch"


def _types():
    """One registry for top-level and nested types; the plan class is
    imported at save/load time (it lives in the ops package)."""
    from spmm_tpu_torch.ops.slab_spgemm import SpgemmPlan

    return {**_TYPES, SpgemmPlan.__name__: SpgemmPlan}


def _is_array_tuple(v) -> bool:
    # static tuples (shape, classes, ...) hold ints and are never empty
    return isinstance(v, tuple) and all(is_array(a) for a in v)


def _flatten(obj, prefix, arrays, meta):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if _is_array_tuple(v):
            meta[key + "__len"] = len(v)
            for i, a in enumerate(v):
                arrays[f"{key}__{i}"] = as_numpy(a)
        elif dataclasses.is_dataclass(v):
            meta[key + "__type"] = type(v).__name__
            _flatten(v, key + ".", arrays, meta)
        elif is_array(v):
            arrays[key] = as_numpy(v)
        else:
            meta[key] = list(v) if isinstance(v, tuple) else v


def _unflatten(cls, prefix, arrays, meta):
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        if key + "__len" in meta:
            kwargs[f.name] = tuple(arrays[f"{key}__{i}"] for i in range(meta[key + "__len"]))
        elif key + "__type" in meta:
            kwargs[f.name] = _unflatten(_types()[meta[key + "__type"]], key + ".", arrays, meta)
        elif key in arrays:
            kwargs[f.name] = arrays[key]
        else:
            v = meta[key]
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def save(path, obj) -> None:
    """Save a container (COO/CSR/BSR/BlockedCSR/ELL, numpy or tensor leaves)
    or a ``SpgemmPlan`` to ``path`` (.npz)."""
    name = type(obj).__name__
    if name not in _types():
        raise TypeError(f"cannot serialize a {name}")
    arrays, meta = {}, {"__type": name}
    if name == "SpgemmPlan":
        meta["__layout"] = _PLAN_LAYOUT
    _flatten(obj, "", arrays, meta)
    # default=: numpy integer scalars in static fields
    blob = json.dumps(meta, default=lambda o: o.item()).encode()
    np.savez_compressed(path, __meta=np.frombuffer(blob, dtype=np.uint8), **arrays)


def load(path):
    """Load what ``save`` (of either package) wrote.  Arrays come back as
    numpy; ``obj.to(device)`` moves a loaded container or plan to a device
    once for reuse."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta"}
    name = meta["__type"]
    if name == "SpgemmPlan" and meta.get("__layout") != _PLAN_LAYOUT:
        raise ValueError(
            f"{path}: a SpgemmPlan written by the JAX package (its tables are "
            "folded for the TPU's tiling); rebuild the plan with "
            "spmm_tpu_torch.ops.spgemm_plan"
        )
    if name not in _types():
        raise ValueError(f"{path}: unknown container type {name!r}")
    return _unflatten(_types()[name], "", arrays, meta)
