"""Driver entry points (port of ``__graft_entry__.py``).

- ``entry()``: the single-chip forward step of the flagship path, blocked
  SpMM over the preprocessed BlockedCSR, each v8-group bucket through
  kernel K2::

      fn, args = entry("cuda")
      Y = fn(*args)          # (4096, 128) fp32, rows in original order

- ``dryrun_multichip(n)``: on every rank of a process group of world size
  n, one full multi-chip step (a ring SpMM over the 'rows' axis of a
  rows×cols mesh, B's columns over 'cols', the loss reduced over both) and
  every distributed SpGEMM strategy, each against scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats.containers import CSR
from spmm_tpu_torch.formats.synthetic import webgraph_like
from spmm_tpu_torch.ops.blocked import blocked_slab_view, blocked_spmm_slab
from spmm_tpu_torch.preprocess import preprocess


def entry(device="cuda"):
    """``(fn, (P, B, view))`` with ``fn = blocked_spmm_slab``: the same graph,
    config, seeds and k = 128 as the JAX package's ``entry()``, every
    tensor on ``device``."""
    A = webgraph_like(4096, 24576, seed=0)
    P = preprocess(A, Config(region_budget=2048, panel_rows=512)).to(device)
    view = blocked_slab_view(P)  # pack once: each bucket of v8 groups is one K2 slab
    B = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4096, 128)).astype(np.float32)
    ).to(device)
    return blocked_spmm_slab, (P, B, view)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _scipy_square(G):
    ref = (G.to_scipy() @ G.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    return ref


def _held(C, ref, what: str, rtol: float = 1e-4) -> None:
    """C's structure equal to scipy's, its values within rtol of max |scipy|."""
    h = C.host()
    _require(C.nnz == ref.nnz, f"{what}: nnz {C.nnz}, scipy {ref.nnz}")
    _require(np.array_equal(np.asarray(h.indptr, np.int64), ref.indptr)
             and np.array_equal(np.asarray(h.indices[: C.nnz]), ref.indices),
             f"{what}: structure differs from scipy's")
    err = float(np.abs(np.asarray(h.data[: C.nnz]) - ref.data).max(initial=0))
    _require(err <= rtol * max(float(np.abs(ref.data).max(initial=0)), 1e-30),
             f"{what}: max err {err:.3e}")


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """One full multi-chip step, then every distributed SpGEMM strategy and
    the column-split SpMM, over ``n_devices`` ranks, each against scipy
    (port of ``__graft_entry__.py: dryrun_multichip``; its tiny shapes and
    seeds).  Every rank of an initialised process group of world size
    ``n_devices`` calls it (SPMD); it raises otherwise.  Rank 0 prints the
    ``dryrun ... OK`` lines.

    The step: a (n/2, 2) rows×cols mesh when n is even and at least 4, else
    (n, 1); Y = A @ B and Z = A @ Y, each a ring over the 'rows' axis
    (``spmm_dist_ring``: each rank's products through ``ops.spmm``, K2 on
    the card for a CSR above its pack threshold), B's columns split over
    'cols', the loss sum(Z²) all-reduced over both axes, and a
    gradient-descent-shaped update of B.  Then ``spgemm_dist_spmd``,
    ``spgemm_dist_csr``, ``spgemm_dist_halo_exchange``, plan / exec twice,
    plan(``b_sharded``) / exec, revalue, big with 2 pieces, big(``b_sharded``)
    on the 'rows' axis, and ``spmm_dist_colsplit`` on a 1-D mesh."""
    import dataclasses

    import torch.distributed as dist

    from spmm_tpu_torch.parallel import (
        make_mesh, partition_cols, partition_rows, spgemm_dist_big, spgemm_dist_csr,
        spgemm_dist_exec, spgemm_dist_halo_exchange, spgemm_dist_plan, spgemm_dist_revalue,
        spgemm_dist_spmd, spmm_dist_colsplit, spmm_dist_ring,
    )
    from spmm_tpu_torch.parallel.mesh import mesh_device

    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) runs on every rank of a process group of world size "
            f"{n_devices} (have {have})"
        )
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    # 2-D mesh when possible: 'rows' = data-parallel row blocks of A,
    # 'cols' = tensor-parallel columns of the dense RHS
    if n_devices % 2 == 0 and n_devices >= 4:
        rows_n, cols_n = n_devices // 2, 2
    else:
        rows_n, cols_n = n_devices, 1
    mesh = make_mesh((rows_n, cols_n), ("rows", "cols"), device=device)
    dev = mesh_device(mesh)

    # ---- the step: two ring products, the loss over the whole mesh --------
    m, k = rows_n * 64, cols_n * 16
    A = webgraph_like(m, m * 4, seed=1)
    S = partition_rows(A, rows_n)
    panel_rows = S.rows_per_shard
    B0 = np.random.default_rng(2).standard_normal((rows_n, panel_rows, k)).astype(np.float32)
    kk, c = k // cols_n, mesh.get_local_rank("cols")
    B = torch.from_numpy(np.ascontiguousarray(B0.reshape(-1, k)[:, c * kk : (c + 1) * kk])).to(dev)
    y = spmm_dist_ring(S, B, mesh, axis="rows")  # (1, rows_pad, kk): this rank's rows of Y
    Y = y.new_empty((rows_n * y.shape[1], kk))
    dist.all_gather_into_tensor(Y, y[0].contiguous(), group=mesh.get_group("rows"))
    z = spmm_dist_ring(S, Y, mesh, axis="rows")  # second product (backward-like): Z = A @ Y
    loss = (z * z).sum().reshape(1)
    for ax in ("rows", "cols"):
        dist.all_reduce(loss, group=mesh.get_group(ax))
    me = mesh.get_local_rank("rows")
    b_new = B[me * panel_rows : (me + 1) * panel_rows] - 1e-3 * z[0]  # B <- B - lr * Z
    _require(bool(torch.isfinite(b_new).all()), "the update is not finite")
    Sp = A.to_scipy()
    y_ref = Sp @ B0.reshape(rows_n * panel_rows, k)[: Sp.shape[1]]
    pad = np.zeros((rows_n * panel_rows, k), np.float32)
    pad[: Sp.shape[0]] = y_ref
    z_ref = Sp @ pad[: Sp.shape[1]]
    loss_ref = float((z_ref * z_ref).sum())
    got = float(loss)
    _require(abs(got - loss_ref) <= 1e-3 * max(1.0, abs(loss_ref)), f"loss {got} vs scipy {loss_ref}")
    say(f"dryrun_multichip OK: mesh={{'rows': {rows_n}, 'cols': {cols_n}}} loss={got:.4e} "
        f"(ref {loss_ref:.4e})")

    # ---- the distributed SpGEMM strategies on the 'rows' axis -------------
    G = webgraph_like(rows_n * 32, rows_n * 160, seed=3)
    Sg = partition_rows(G, rows_n)
    ref = _scipy_square(G)
    C = spgemm_dist_spmd(Sg, G, mesh, classes=(16, 64), slot_budget=1 << 14)
    _held(C, ref, "spgemm_dist_spmd")
    say(f"dryrun spgemm_dist_spmd OK: nnz={C.nnz} over {rows_n} shards")

    # device-resident output: each rank's row block of C stays on its device
    Cd = spgemm_dist_csr(Sg, G, mesh, classes=(16, 64, 256, 1024, 4096), slot_budget=1 << 14)
    _require(Cd.nnz == ref.nnz and Cd.data.device.type == dev.type,
             f"spgemm_dist_csr: nnz {Cd.nnz} on {Cd.data.device}, scipy {ref.nnz}")
    h, lo = Cd.host(), int(Sg.row_starts[me])
    own = max(min(Sg.rows_per_shard, G.nrow - lo), 0)
    iptr = np.asarray(h.indptr[0], np.int64)[: own + 1]
    blk = CSR(data=h.data[0][: iptr[-1]], indices=h.indices[0][: iptr[-1]], indptr=iptr,
              shape=(own, G.ncol), nnz=int(iptr[-1]))
    _held(blk, ref[lo : lo + own], "spgemm_dist_csr (this rank's rows)")
    say(f"dryrun spgemm_dist_csr OK: device-resident nnz={Cd.nnz}")

    # runtime halo exchange: B row-block sharded, halos by all_to_all_single
    Ce = spgemm_dist_halo_exchange(Sg, G, mesh, slot_budget=1 << 14)
    _held(Ce, ref, "spgemm_dist_halo_exchange")
    say(f"dryrun spgemm_dist_halo_exchange OK: nnz={Ce.nnz}")

    # two-phase: plan once, re-execute the gather-free numeric phase
    dp = spgemm_dist_plan(Sg, G, mesh, classes=(16, 64), slot_budget=1 << 14)
    for _ in range(2):
        Cp = spgemm_dist_exec(dp, mesh)
        _held(Cp, ref, "spgemm_dist_plan / exec")
    say(f"dryrun spgemm_dist_plan/exec OK: nnz={Cp.nnz} (2 re-execs)")

    # two-phase with B row-block sharded: the halo exchanged at plan time
    dpb = spgemm_dist_plan(Sg, G, mesh, classes=(16, 64), slot_budget=1 << 14, b_sharded=True)
    Cpb = spgemm_dist_exec(dpb, mesh)
    _held(Cpb, ref, "spgemm_dist_plan(b_sharded) / exec")
    say(f"dryrun spgemm_dist_plan(b_sharded)/exec OK: nnz={Cpb.nnz}")

    # revalue: same structure, new values, no new sizing or exchange maps
    rng = lambda s: np.random.default_rng(s).standard_normal(G.data.shape[0]).astype(np.float32)
    Gv, Gv2 = dataclasses.replace(G, data=rng(9)), dataclasses.replace(G, data=rng(10))
    dpv = spgemm_dist_plan(partition_rows(Gv, rows_n), Gv, mesh, classes=(16, 64), slot_budget=1 << 14)
    Cv = spgemm_dist_exec(spgemm_dist_revalue(dpv, partition_rows(Gv2, rows_n), Gv2, mesh), mesh)
    refv = _scipy_square(Gv2)
    _held(Cv, refv, "spgemm_dist_revalue")
    err = float(np.abs(Cv.data[: Cv.nnz] - refv.data).max() / max(np.abs(refv.data).max(), 1e-9))
    say(f"dryrun spgemm_dist_revalue OK: nnz={Cv.nnz} rel_err={err:.1e}")

    # the streamed big path: 2 pieces per rank, B replicated, then sharded
    Cb = spgemm_dist_big(G, G, mesh, pieces=2, slot_budget=1 << 14)
    _held(Cb, ref, "spgemm_dist_big")
    say(f"dryrun spgemm_dist_big OK: nnz={Cb.nnz} (2 pieces x {rows_n} shards)")
    Cbs = spgemm_dist_big(G, G, mesh, pieces=2, slot_budget=1 << 14, b_sharded=True)
    _held(Cbs, ref, "spgemm_dist_big(b_sharded)")
    say(f"dryrun spgemm_dist_big(b_sharded) OK: nnz={Cbs.nnz}")

    # contraction-split SpMM on a 1-D mesh: A column-sharded, Y reduce-scattered
    rmesh = make_mesh((n_devices,), ("rows",), device=device)
    Bc = np.random.default_rng(4).standard_normal((G.shape[1], 16)).astype(np.float32)
    yc = spmm_dist_colsplit(partition_cols(G, n_devices), torch.from_numpy(Bc).to(dev), rmesh)[0]
    Yc = yc.new_empty((n_devices * yc.shape[0], 16))
    dist.all_gather_into_tensor(Yc, yc.contiguous(), group=rmesh.get_group("rows"))
    Yc = Yc.cpu().numpy()[: G.shape[0]]
    ref_y = G.to_scipy() @ Bc
    err = float(np.abs(Yc - ref_y).max() / max(np.abs(ref_y).max(), 1e-9))
    _require(err < 1e-5, f"spmm_dist_colsplit: rel err {err:.1e}")
    say(f"dryrun spmm_dist_colsplit OK: rel_err={err:.1e} over {n_devices} col shards")
