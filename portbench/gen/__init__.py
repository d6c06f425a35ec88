"""The benchmark's inputs, made from a configuration and a seed."""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.gen.webgraph import webgraph_like

GENERATORS = {"webgraph_like": webgraph_like}


@dataclasses.dataclass(frozen=True)
class Graph:
    """A square sparse matrix in host CSR arrays: int32 ``indptr`` and
    ``indices`` (columns ascending in each row), ``data`` in the
    configuration's dtype."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def make_graph(config: dict, seed: int, values: str) -> Graph:
    """The configuration's graph, with ``values`` "ones" (the link pattern)
    or "normal" (standard normal values drawn from the run's ``seed``).  The
    structure comes from the configuration's own structure seed (its
    generator's ``seed``), the same in every run: the seed would otherwise
    change the work (on web-Google, A×A holds 24.2M to 37.7M entries as the
    structure seed goes), and a run's numbers would follow the seed instead
    of the program."""
    gen = dict(config["generator"])
    fn = GENERATORS[gen.pop("name")]
    gen.setdefault("seed", 0)
    indptr, indices = fn(**gen)
    dtype = np.dtype(config["dtype"])
    nnz = int(indptr[-1])
    if values == "ones":
        data = np.ones(nnz, dtype)
    elif values == "normal":
        data = np.random.default_rng([seed, 0, 1]).standard_normal(nnz, dtype=np.float64).astype(dtype)
    else:
        raise ValueError(f"unknown values {values!r}")
    return Graph(indptr=indptr, indices=indices, data=data, n=len(indptr) - 1)
