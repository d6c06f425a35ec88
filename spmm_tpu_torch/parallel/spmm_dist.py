"""Distributed SpMM / SpMV over a ``DeviceMesh`` (port of
``spmm_tpu/parallel/spmm_dist.py``).

Row/block-partition the left matrix across ranks; the right-hand side is
either all-gathered (small B), ring-shifted with paired sends and receives so
each rank streams remote panels through while it computes, or, with the
contraction axis sharded, left in place while the partial products are
reduce-scattered.

One process per rank (SPMD): every rank calls the same function with the same
``ShardedCSR`` and global B, slices its own panel of B, and returns its own
block with a leading axis of 1; stacking the ranks' blocks gives the JAX
package's ``(n_shards, ...)`` result.  Each rank's local product is the
port's ``ops.spmm`` on its shard (:func:`~spmm_tpu_torch.parallel.partition.
local_shard`): kernel K2 on the card above ``ops.spmm.AUTO_ELL_THRESHOLD``
nonzeros, the gather and the ordered segment sum below it, summed in fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats.containers import CSR, as_numpy, as_tensor, memo_of
from spmm_tpu_torch.parallel.mesh import axis_size, check_on_mesh, mesh_device
from spmm_tpu_torch.parallel.partition import ColShardedCSR, ShardedCSR, local_shard


def _my_panel(mesh: DeviceMesh, B: torch.Tensor, n: int, axis: str) -> torch.Tensor:
    """This rank's row panel of the global B (JAX's ``B.reshape(n, -1, k)``
    under ``P(axis)``), contiguous on the mesh's device."""
    check_on_mesh(mesh, B, "B")
    if B.shape[0] % n:
        raise ValueError(f"B has {B.shape[0]} rows, not a multiple of the {n} ranks on {axis!r}")
    rows = B.shape[0] // n
    me = mesh.get_local_rank(axis)
    return B[me * rows : (me + 1) * rows].to(mesh_device(mesh)).contiguous()


def spmm_dist(S: ShardedCSR, B: torch.Tensor, mesh: DeviceMesh, *, axis: str = "rows") -> torch.Tensor:
    """Y = A @ B with A row-sharded and B row-sharded over ``axis``.

    Each rank all-gathers B (one collective), then computes its row block.
    Returns this rank's block of Y as (1, rows_pad, k)."""
    n = axis_size(mesh, axis)
    if S.n_shards != n:
        raise ValueError(f"matrix has {S.n_shards} shards, mesh axis {axis} has {n}")
    panel = _my_panel(mesh, B, n, axis)
    b = panel.new_empty((n * panel.shape[0], panel.shape[1]))
    dist.all_gather_into_tensor(b, panel, group=mesh.get_group(axis))
    y = ops.spmm(local_shard(S, mesh.get_local_rank(axis), panel.device), b)
    return y[None]


def _panel_shards(S: ShardedCSR, index: int, n: int, panel_rows: int, device) -> list:
    """Shard ``index`` split by owner panel once: n local CSRs of shape
    (rows_pad, panel_rows) whose columns are relocalised to panel ``o``'s
    rows.  Each keeps its nonzeros in row order.  Memoized on ``S``."""
    dev = torch.device(device)
    memo = memo_of(S, "_ring_panels")
    key = (int(index), n, panel_rows, str(dev))
    if memo is not None and key in memo:
        return memo[key]
    iptr = as_numpy(S.indptr[index]).astype(np.int64)
    nnz = int(iptr[-1])
    cols = as_numpy(S.indices[index][:nnz]).astype(np.int64)
    vals = as_numpy(S.data[index][:nnz])
    rows = np.repeat(np.arange(len(iptr) - 1, dtype=np.int64), np.diff(iptr))
    owner = cols // panel_rows
    subs = []
    for o in range(n):
        sel = np.flatnonzero(owner == o)
        sub_iptr = np.zeros(len(iptr), np.int64)
        np.cumsum(np.bincount(rows[sel], minlength=len(iptr) - 1), out=sub_iptr[1:])
        subs.append(CSR(
            data=as_tensor(vals[sel], dev),
            indices=as_tensor((cols[sel] - o * panel_rows).astype(np.int32), dev),
            indptr=as_tensor(sub_iptr, dev),
            shape=(len(iptr) - 1, panel_rows),
            nnz=len(sel),
        ))
    if memo is not None:
        memo[key] = subs
    return subs


def spmm_dist_ring(S: ShardedCSR, B: torch.Tensor, mesh: DeviceMesh, *, axis: str = "rows") -> torch.Tensor:
    """Y = A @ B with B ring-shifted instead of all-gathered.

    At step t each rank multiplies against the B panel first owned by rank
    (me + t) % n and passes its current panel to the left neighbour; the
    exchange for step t + 1 is in flight (``batch_isend_irecv``) while step t
    multiplies.  Only the nonzeros whose column falls inside the current
    panel contribute at each step: the shard is split by owner panel once
    (:func:`_panel_shards`), so each step is one ``ops.spmm``.  The partial
    products are added step by step.  Returns (1, rows_pad, k)."""
    n = axis_size(mesh, axis)
    if S.n_shards != n:
        raise ValueError(f"matrix has {S.n_shards} shards, mesh axis {axis} has {n}")
    panel = _my_panel(mesh, B, n, axis)
    panel_rows = panel.shape[0]
    me = mesh.get_local_rank(axis)
    subs = _panel_shards(S, me, n, panel_rows, panel.device)
    group = mesh.get_group(axis)
    left = dist.get_global_rank(group, (me - 1) % n)
    right = dist.get_global_rank(group, (me + 1) % n)
    y = None
    for t in range(n):
        reqs, nxt = [], None
        if t + 1 < n:
            nxt = torch.empty_like(panel)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, panel, left, group),
                dist.P2POp(dist.irecv, nxt, right, group),
            ])
        part = ops.spmm(subs[(me + t) % n], panel)
        y = part if y is None else y.add_(part)  # the first step's product starts the sum
        for r in reqs:
            r.wait()
        if nxt is not None:
            panel = nxt
    return y[None]


def spmv_dist(S: ShardedCSR, x: torch.Tensor, mesh: DeviceMesh, *, axis: str = "rows") -> torch.Tensor:
    """y = A @ x, row-sharded; x all-gathered.  Returns (1, rows_pad)."""
    return spmm_dist(S, x[:, None], mesh, axis=axis)[..., 0]


def spmm_dist_colsplit(Sc: ColShardedCSR, B: torch.Tensor, mesh: DeviceMesh, *,
                       axis: str = "rows") -> torch.Tensor:
    """Y = A @ B with the CONTRACTION axis sharded: A column-block sharded
    (``partition_cols``), B row-sharded to match.  Each rank computes a
    full-height partial product from its K slab with no communication, then
    one ``reduce_scatter_tensor`` sums the partials and row-shards Y (the
    tensor-parallel mirror of ``spmm_dist``'s row split; the only traffic is
    the output reduction, never A or B).  Returns (1, rows_pad / n, k)."""
    n = axis_size(mesh, axis)
    if Sc.n_shards != n:
        raise ValueError(f"matrix has {Sc.n_shards} col shards, mesh axis {axis} has {n}")
    if B.shape[0] != Sc.shape[1]:
        raise ValueError(f"B has {B.shape[0]} rows but A has {Sc.shape[1]} columns")
    check_on_mesh(mesh, B, "B")
    me = mesh.get_local_rank(axis)
    lo = me * Sc.cols_per_shard
    panel = B[lo : lo + Sc.cols_per_shard].to(mesh_device(mesh))
    short = Sc.cols_per_shard - panel.shape[0]  # B's rows padded to n * cols_per
    if short:
        panel = torch.cat([panel, panel.new_zeros((short, B.shape[1]))])
    y_part = ops.spmm(local_shard(Sc, me, panel.device), panel.contiguous())
    y = y_part.new_empty((Sc.rows_pad // n, B.shape[1]))
    dist.reduce_scatter_tensor(y, y_part, group=mesh.get_group(axis))
    return y[None]

