"""SpMM training traffic: one call is a training step of a sparse layer with
learnable edge weights: Y = ``ops.ell_spmm(E, X)``, loss = Σ Y², the
gradients with respect to X and to E's values, and ``loss.item()``.

Parameters: ``k`` (X's columns), ``values`` ("normal" or "ones").  X is
drawn from the seed on the device; E is the program's ELL pack of the graph,
built in set-up."""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from portbench import judge as J
from portbench.counts import bytes as nbytes
from portbench.gen import make_graph
from portbench.reference.spmm import train_step

#: the limits of the numbers compared (PERF.md gives the readings they were set from)
LIMITS = {"pack_mismatches": 0.0, "loss_err": 3e-5, "y_err": 3e-4, "gx_err": 1e-3, "gv_err": 1e-4}
KEEP = 3
WARM_CALLS = 3


@dataclasses.dataclass
class State:
    graph: object
    X: torch.Tensor
    E: object
    device: torch.device
    layout: tuple = ()  #: the pack's row order, empty rows and slab columns, kept for the judge


@dataclasses.dataclass
class StepOut:
    loss: float
    y: torch.Tensor
    gx: torch.Tensor
    gv: tuple  #: the values' gradient as the program gives it: one tensor per slab of E
    entries: bool = False  #: ``gv`` is one tensor in CSR order instead


def setup(config, traffic, seed, device):
    from spmm_tpu_torch.formats.containers import CSR
    from spmm_tpu_torch.formats.ell import ell_pack

    dev = torch.device(device)
    g = make_graph(config, seed, traffic["values"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    X = torch.randn((g.n, traffic["k"]), generator=gen, device=dev, dtype=torch.float32)
    E = ell_pack(CSR(data=g.data, indices=g.indices, indptr=g.indptr, shape=(g.n, g.n), nnz=g.nnz)).to(dev)
    E = dataclasses.replace(E, data=tuple(d.requires_grad_() for d in E.data))
    st = State(g, X.requires_grad_(), E, dev)
    for _ in range(WARM_CALLS):
        call(st)
    return st


def call(st: State) -> StepOut:
    from spmm_tpu_torch import ops

    y = ops.ell_spmm(st.E, st.X)
    loss = (y * y).sum()
    gx, *gv = torch.autograd.grad(loss, [st.X, *st.E.data], allow_unused=True)
    return StepOut(loss.item(), y.detach(), gx, tuple(gv))


def counts(st: State) -> dict:
    g, k = st.graph, st.X.shape[1]
    cols = np.bincount(g.indices, minlength=g.n) > 0
    rows = np.diff(g.indptr) > 0
    x_rows, y_rows = int(cols.sum()), int(rows.sum())
    least = (nbytes.spmm(g.n, g.nnz, k, x_rows)  # Y = A·X
             + nbytes.dense_loss(g.n, k)  # Σ Y² and dY = 2·Y
             + nbytes.spmm(g.n, g.nnz, k, y_rows)  # grad X = Aᵀ·dY
             + nbytes.sddmm(g.n, g.nnz, k, y_rows, x_rows))  # grad values
    return {"spmm_least_bytes": float(least)}


def release(st: State) -> None:
    from spmm_tpu_torch.formats.containers import as_numpy

    E, st.E = st.E, None  # the pack and the program's memoized tables go with it
    st.layout = (as_numpy(E.perm).astype(np.int64), E.n_empty, [as_numpy(c) for c in E.cols])
    del E
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _slab_entries(st: State):
    """For each slab of the program's pack, the CSR position of each slot
    (-1 for padding), and the mismatches between the slabs' columns and A's
    (every entry of A has to lie in exactly one slot): the judge reads the
    program's slab gradients through them."""
    g = st.graph
    perm, lo, slab_cols = st.layout
    lens = np.diff(g.indptr.astype(np.int64))
    pos, mism = [], 0
    for cols in slab_cols:
        R, L = cols.shape
        rows = perm[lo : lo + R]
        lo += R
        slot = np.arange(L)[None, :]
        live = slot < lens[rows][:, None]
        p = np.where(live, g.indptr[rows].astype(np.int64)[:, None] + slot, -1)
        mism += int((cols[live] != g.indices[p[live]]).sum())
        pos.append(p)
    live = np.concatenate([p[p >= 0] for p in pos]) if pos else np.zeros(0, np.int64)
    mism += int((np.bincount(live, minlength=g.nnz) != 1).sum())
    return pos, mism


def judge(st: State, kept, device) -> list:
    g = st.graph
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ref = train_step(t(g.indptr), t(g.indices), t(g.data), st.X.detach().to(device))
    checks = []
    pos = None
    for _, out in kept:
        if out.entries:
            gv = out.gv
        elif out.gx is None or any(s is None for s in out.gv):  # a gradient that never came
            checks.append(J.Check("gv_err", None, LIMITS["gv_err"]))
            continue
        else:
            if pos is None:
                pos, mism = _slab_entries(st)
                checks.append(J.Check("pack_mismatches", float(mism), LIMITS["pack_mismatches"]))
            gv = torch.zeros(g.nnz, dtype=torch.float64, device=device)
            for p, s in zip(pos, out.gv):
                p = torch.from_numpy(p).to(device)
                live = p >= 0
                gv[p[live]] = s.detach().to(device, torch.float64)[live]
        checks += [
            J.Check("loss_err", abs(out.loss - float(ref["loss"])) / float(ref["loss"]), LIMITS["loss_err"]),
            J.Check("y_err", J.scaled_err(out.y, ref["y"], ref["y_scale"]), LIMITS["y_err"]),
            J.Check("gx_err", J.scaled_err(out.gx, ref["gx"], ref["gx_scale"]), LIMITS["gx_err"]),
            J.Check("gv_err", J.scaled_err(gv, ref["gv"], ref["gv_scale"]), LIMITS["gv_err"]),
        ]
    return J.worst(checks)


def control(st: State, device) -> StepOut:
    """The step by the reference in bfloat16, in the program's form."""
    g = st.graph
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    r = train_step(t(g.indptr), t(g.indices), t(g.data), st.X.detach().to(device), dtype=torch.bfloat16)
    return StepOut(float(r["loss"]), r["y"].float(), r["gx"].float(), r["gv"].float(), entries=True)
