"""SpGEMM traffic: one call is ``ops.spgemm(A, A)``, a host CSR in and a
host CSR out, on the configuration's graph made in set-up.

Parameters: ``operands`` ("fresh": every call gets a new CSR object over the
arrays, so no call meets an operand it has seen and the program's plan
cache, which holds operands by identity, never hits; "same": every call
passes the same object, so the program may reuse what it derived from it),
``values`` ("normal" or "ones")."""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from portbench import judge as J
from portbench.counts import bytes as nbytes
from portbench.gen import make_graph
from portbench.reference.spgemm import spgemm as spgemm_reference

#: the limits of the numbers compared (PERF.md gives the readings they were set from)
LIMITS = {"c_structure_mismatches": 0.0, "c_value_err": 1e-4}
KEEP = 3
WARM_CALLS = {"fresh": 2, "same": 4}


@dataclasses.dataclass
class State:
    graph: object
    operand: object
    fresh: bool
    device: torch.device
    c_nnz: int = 0


def setup(config, traffic, seed, device):
    from spmm_tpu_torch.formats.containers import CSR

    g = make_graph(config, seed, traffic["values"])
    A = CSR(data=g.data, indices=g.indices, indptr=g.indptr, shape=(g.n, g.n), nnz=g.nnz)
    st = State(g, A, traffic["operands"] == "fresh", torch.device(device))
    for _ in range(WARM_CALLS[traffic["operands"]]):
        st.c_nnz = call(st).nnz
    return st


def call(st: State):
    from spmm_tpu_torch import ops

    A = dataclasses.replace(st.operand) if st.fresh else st.operand
    return ops.spgemm(A, A, device=st.device)


def counts(st: State) -> dict:
    g = st.graph
    return {"spgemm_least_bytes": float(nbytes.spgemm(g.n, g.nnz, st.c_nnz, val=g.data.itemsize))}


def release(st: State) -> None:
    st.operand = None  # the program's plan is keyed to this object
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(graph, device, dtype):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ip, ix, dv = t(graph.indptr), t(graph.indices), t(graph.data)
    return spgemm_reference(ip, ix, dv, ip, ix, dv, graph.n, dtype=dtype)


def _row_scale(indptr, scale):
    """Each entry's row's sum of absolute partial products."""
    rows = torch.repeat_interleave(torch.arange(len(indptr) - 1, device=indptr.device), indptr.diff())
    return torch.zeros(len(indptr) - 1, dtype=torch.float64, device=indptr.device).index_add_(0, rows, scale)[rows]


def judge(st: State, kept, device) -> list:
    checks = []
    indptr, indices, data, scale = _reference(st.graph, device, torch.float64)
    if torch.device(device).type != "cuda":
        # the kernels' plain version sums a row's products by prefix
        # differences, so an entry keeps only to its row's scale; on the
        # card K4 sums each entry's own products, and each entry keeps to
        # its own
        scale = _row_scale(indptr, scale)
    for _, C in kept:
        c_ptr = torch.from_numpy(np.asarray(C.indptr, np.int64)).to(device)
        c_idx = torch.from_numpy(np.asarray(C.indices[: C.nnz], np.int64)).to(device)
        c_val = torch.from_numpy(np.asarray(C.data[: C.nnz])).to(device)
        same_len = c_ptr.shape == indptr.shape and c_idx.shape == indices.shape
        mism = abs(len(c_idx) - len(indices))
        if c_ptr.shape == indptr.shape:
            mism += int((c_ptr != indptr).sum())
        if same_len:
            mism += int((c_idx != indices).sum())
        checks.append(J.Check("c_structure_mismatches", float(mism), LIMITS["c_structure_mismatches"]))
        err = J.scaled_err(c_val, data.double(), scale) if mism == 0 else None
        checks.append(J.Check("c_value_err", err, LIMITS["c_value_err"]))
    del indptr, indices, data, scale
    return J.worst(checks)


@dataclasses.dataclass(frozen=True)
class HostCSR:
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    nnz: int


def control(st: State, device):
    """The product by the reference in bfloat16, in the program's form."""
    indptr, indices, data, _ = _reference(st.graph, device, torch.bfloat16)
    return HostCSR(indptr.cpu().numpy(), indices.cpu().numpy(), data.float().cpu().numpy(), int(indptr[-1]))
