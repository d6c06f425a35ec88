"""Rank side of the distributed port's tests: a pool of gloo ranks on the CPU,
and the tasks they run.

PyTorch has no virtual devices, so the distributed port is tested on real
processes: :class:`RankPool` spawns ``RANKS`` processes (the ``spawn``
method: a fresh interpreter each, no fork of a process with threads), each
joins one gloo process group and then runs the tasks it is fed through its
queue.  A task is a function of this module (pickled by its import path);
every rank runs it with the same arguments, as an SPMD program, and puts its
result on the shared result queue.  The parent waits for each result with a
deadline: a rank that hangs, say in a collective that another rank never
joins, fails the call within that deadline, and the pool is killed and
started anew on the next call.

This module imports neither JAX nor any test module, so the ranks never load
JAX.  Each rank runs torch on one thread (``torch_parity.one_torch_thread``'s
reasoning: six test workers already share the CPUs).

    pool = RankPool(); blocks = pool.run(spmm_task, "spmm_dist", S, B); pool.close()
"""

from __future__ import annotations

import importlib
import multiprocessing
import queue
import socket
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

RANKS = 4
#: ``init_process_group``'s timeout: the rendezvous and every gloo collective
COLLECTIVE_TIMEOUT_S = 60
#: deadline for the pool's start (spawn, imports, rendezvous)
START_TIMEOUT_S = 120
#: default deadline for one task's results
TASK_TIMEOUT_S = 60


class RankTimeout(AssertionError):
    """A rank gave no result within the deadline (the pool was killed)."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, tasks, results) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        )
    except Exception:  # reported to the parent, which fails the start
        results.put((rank, 0, False, traceback.format_exc()))
        return
    results.put((rank, 0, True, None))
    while True:
        item = tasks.get()
        if item is None:
            break
        seq, fn, args, kwargs = item
        try:
            results.put((rank, seq, True, fn(*args, **kwargs)))
        except Exception:  # the task failed: its traceback is the result
            results.put((rank, seq, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks kept alive across calls of :meth:`run`."""

    def __init__(self, world: int = RANKS):
        self.world = world
        self.procs: list = []
        self.seq = 0

    @property
    def alive(self) -> bool:
        return bool(self.procs) and all(p.is_alive() for p in self.procs)

    def start(self) -> None:
        self.close()
        ctx = multiprocessing.get_context("spawn")
        self.tasks = [ctx.Queue() for _ in range(self.world)]
        self.results = ctx.Queue()
        port = free_port()
        self.procs = [
            ctx.Process(target=_rank_main, args=(r, self.world, port, self.tasks[r], self.results),
                        daemon=True)
            for r in range(self.world)
        ]
        for p in self.procs:
            p.start()
        self.seq = 0
        self._collect(0, START_TIMEOUT_S)

    def run(self, fn, *args, timeout: float = TASK_TIMEOUT_S, **kwargs) -> list:
        """Run ``fn(*args, **kwargs)`` on every rank; the ranks' results in
        rank order.  Raises AssertionError with the tracebacks of the ranks
        that raised, :class:`RankTimeout` when a rank gives no result within
        ``timeout`` seconds."""
        if not self.alive:
            self.start()
        self.seq += 1
        for q in self.tasks:
            q.put((self.seq, fn, args, kwargs))
        return self._collect(self.seq, timeout)

    def _collect(self, seq: int, timeout: float) -> list:
        deadline = time.monotonic() + timeout
        got, errors = {}, {}
        while len(got) + len(errors) < self.world:
            left = deadline - time.monotonic()
            if left <= 0 or not self.alive:
                missing = sorted(set(range(self.world)) - set(got) - set(errors))
                why = "died" if left > 0 else f"gave no result within {timeout:g} s"
                self.close(kill=True)
                raise RankTimeout(f"ranks {missing} {why} (task {seq}); the pool was killed")
            try:
                rank, s, ok, out = self.results.get(timeout=min(left, 0.5))
            except queue.Empty:
                continue
            if s != seq:
                continue  # a late result of an earlier task
            (got if ok else errors)[rank] = out
        if errors:
            raise AssertionError("".join(f"rank {r}:\n{tb}" for r, tb in sorted(errors.items())))
        return [got[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        """Stop every rank: ask (unless ``kill``), then kill what is still
        there."""
        self.procs = [p for p in self.procs if p.pid is not None]  # started ones
        if not self.procs:
            return
        if not kill:
            for q in self.tasks:
                q.put(None)
            end = time.monotonic() + 5
            for p in self.procs:
                p.join(max(end - time.monotonic(), 0))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        for q in self.tasks + [self.results]:
            q.cancel_join_thread()
            q.close()
        self.procs = []


# ---------------------------------------------------------------------------
# tasks: every rank runs one with the same arguments
# ---------------------------------------------------------------------------


def _cpu_mesh(*args, **kwargs):
    from spmm_tpu_torch.parallel import make_mesh

    return make_mesh(*args, device="cpu", **kwargs)


def env_task() -> dict:
    """What the rank has loaded and how it runs."""
    import torch.distributed as dist

    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": str(dist.get_backend()), "threads": torch.get_num_threads(),
            "jax": "jax" in sys.modules,
            "spmm_tpu": any(m == "spmm_tpu" or m.startswith("spmm_tpu.") for m in sys.modules)}


def mesh_2d_task() -> dict:
    """A (2, 2) mesh: this rank's coordinate, the axis sizes and the ranks
    gathered along each axis."""
    import torch.distributed as dist

    from spmm_tpu_torch.parallel.mesh import axis_size

    mesh = _cpu_mesh((2, 2), ("rows", "cols"))
    out = {"coord": tuple(mesh.get_coordinate()),
           "index": {a: mesh.get_local_rank(a) for a in ("rows", "cols")},
           "size": {a: axis_size(mesh, a) for a in ("rows", "cols")}}
    for a in ("rows", "cols"):
        me = torch.tensor([dist.get_rank()], dtype=torch.int64)
        buf = me.new_empty(axis_size(mesh, a))
        dist.all_gather_into_tensor(buf, me, group=mesh.get_group(a))
        out[f"gather_{a}"] = buf.tolist()
    return out


def make_mesh_errors_task() -> list:
    """The ValueErrors of ``make_mesh`` (too many devices, axis names that
    do not match the shape, a CUDA mesh on gloo) and of a B on another
    device than the mesh's."""
    from spmm_tpu_torch.parallel import make_mesh, partition_rows, spmm_dist
    from spmm_tpu_torch.formats.synthetic import random_csr

    msgs = []
    for call in (lambda: make_mesh(8, device="cpu"),
                 lambda: make_mesh((2, 2), ("rows",), device="cpu"),
                 lambda: make_mesh(device="cuda")):
        try:
            call()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    S = partition_rows(random_csr(64, 64, 0.1, seed=0), RANKS)
    try:
        spmm_dist(S, torch.zeros((64, 4), device="meta"), _cpu_mesh())
        msgs.append(None)
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def spmm_task(name: str, S, B: np.ndarray, *, ell: bool = False) -> dict:
    """One distributed SpMM entry point on this rank's shard, called twice:
    its block each time, the second call's host ms, and how many ELL packs
    the calls made (the local
    product's K2 route; K2's plain version here).  ``ell`` lowers
    ``ops.spmm``'s pack threshold to 0 for the calls, so a small shard takes
    that route as a large one does on the card; the second call reuses the
    packs memoized with the shard."""
    from spmm_tpu_torch import parallel

    spmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")  # the module, not ops.spmm
    mesh = _cpu_mesh()
    fn = getattr(parallel, name)
    thr = spmm_mod.AUTO_ELL_THRESHOLD
    before = set(spmm_mod._ELL_CACHE)
    if ell:
        spmm_mod.AUTO_ELL_THRESHOLD = 0
    try:
        Y = fn(S, torch.from_numpy(B), mesh)
        packed = len(set(spmm_mod._ELL_CACHE) - before)
        t0 = time.perf_counter()
        Y2 = fn(S, torch.from_numpy(B), mesh)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        spmm_mod.AUTO_ELL_THRESHOLD = thr
    assert len(set(spmm_mod._ELL_CACHE) - before) == packed, "the second call packed again"
    return {"block": Y.numpy(), "again": Y2.numpy(), "packed": packed, "ms": ms}


def spgemm_task(S, B, **kw) -> dict:
    """``spgemm_dist_spmd``: the global host CSR this rank returns, and the
    call's host ms."""
    from spmm_tpu_torch.parallel import spgemm_dist_spmd

    mesh = _cpu_mesh()
    t0 = time.perf_counter()
    C = spgemm_dist_spmd(S, B, mesh, **kw)
    return {"C": C.host(), "ms": (time.perf_counter() - t0) * 1e3}


def spgemm_raw_task(S, B, **kw) -> dict:
    """``spgemm_dist_spmd(as_csr=False)``: this rank's chunk outputs' live
    entries (rows in the shard's row space) and its tail rows."""
    from spmm_tpu_torch.ops.slab_spgemm import _pull_chunks
    from spmm_tpu_torch.parallel import spgemm_dist_spmd

    rows_sorted, outs, tails = spgemm_dist_spmd(S, B, _cpu_mesh(), as_csr=False, **kw)
    assert rows_sorted.shape[0] == 1 and all(x.shape[0] == 1 for o in outs for x in o)
    r, c, v = _pull_chunks([tuple(x[0] for x in o) for o in outs])
    cat = lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt)
    return {"rows": cat(r, np.int64), "cols": cat(c, np.int64), "vals": cat(v, np.float32),
            "tails": [np.asarray(t) for t in tails]}


def spgemm_csr_task(S, B, **kw) -> dict:
    """``spgemm_dist_csr``: this rank's device-resident block and the call's
    host ms, or the ValueError's message."""
    from spmm_tpu_torch.parallel import spgemm_dist_csr

    mesh = _cpu_mesh()
    t0 = time.perf_counter()
    try:
        C = spgemm_dist_csr(S, B, mesh, **kw)
    except ValueError as e:
        return {"error": str(e)}
    ms = (time.perf_counter() - t0) * 1e3
    return {"tensors": all(isinstance(x, torch.Tensor) for x in (C.data, C.indices, C.indptr)),
            "block": C.host(), "nnz": C.nnz, "ms": ms}


def hang_task() -> int:
    """Rank 0 never joins the all-reduce the others wait in."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        return 0
    t = torch.ones(1)
    dist.all_reduce(t)
    return int(t)
