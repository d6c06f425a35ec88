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

import contextlib
import importlib
import io
import multiprocessing
import queue
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

from spmm_tpu_torch.parallel.mesh import free_port

RANKS = 4
#: ``init_process_group``'s timeout: the rendezvous and every gloo collective
COLLECTIVE_TIMEOUT_S = 60
#: deadline for the pool's start (spawn, imports, rendezvous)
START_TIMEOUT_S = 120
#: default deadline for one task's results
TASK_TIMEOUT_S = 60


class RankTimeout(AssertionError):
    """A rank gave no result within the deadline (the pool was killed)."""


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


@contextlib.contextmanager
def _watch():
    """Record on this rank, while the block runs: the payload dtype of every
    ``all_to_all_single``, the (rows, nnz, device type) of every B that
    reached the slab tables (``_plan_tables``) and of every B that the tail
    rows' global-sort ESC multiplied (``spgemm_sorted``), the nnz of every
    block of B this rank sent its share of the halos from, and the number of
    pieces ``_piece_csr`` computed."""
    import torch.distributed as dist

    from spmm_tpu_torch.ops import slab_spgemm
    from spmm_tpu_torch.parallel import spgemm_spmd

    seen = {"a2a": [], "b": [], "sorted": [], "block": [], "pieces": 0}
    real_a2a, real_tables, real_sorted, real_piece, real_body = (
        dist.all_to_all_single, slab_spgemm._plan_tables, slab_spgemm.spgemm_sorted,
        spgemm_spmd._piece_csr, spgemm_spmd._exchange_halo_body)

    def a2a(out, inp, *a, **k):
        seen["a2a"].append(str(inp.dtype).removeprefix("torch."))
        return real_a2a(out, inp, *a, **k)

    def tables(A, B, *a, **k):
        seen["b"].append((int(B.shape[0]), int(B.nnz), B.indices.device.type))
        return real_tables(A, B, *a, **k)

    def esc(A, B, *a, **k):
        seen["sorted"].append((int(B.shape[0]), int(B.nnz), B.indices.device.type
                               if isinstance(B.indices, torch.Tensor) else "host"))
        return real_sorted(A, B, *a, **k)

    def piece(*a, **k):
        seen["pieces"] += 1
        return real_piece(*a, **k)

    def body(block, *a, **k):
        seen["block"].append(int(block.nnz))
        return real_body(block, *a, **k)

    dist.all_to_all_single = a2a
    slab_spgemm._plan_tables = spgemm_spmd._plan_tables = tables
    slab_spgemm.spgemm_sorted = esc
    spgemm_spmd._piece_csr, spgemm_spmd._exchange_halo_body = piece, body
    try:
        yield seen
    finally:
        dist.all_to_all_single = real_a2a
        slab_spgemm._plan_tables = spgemm_spmd._plan_tables = real_tables
        slab_spgemm.spgemm_sorted = real_sorted
        spgemm_spmd._piece_csr, spgemm_spmd._exchange_halo_body = real_piece, real_body


def halo_task(name: str, S, B, **kw) -> dict:
    """``spgemm_dist_halo`` or ``spgemm_dist_halo_exchange``: the global host
    CSR this rank returns and the call's host ms, with what ``_watch`` saw
    during the call."""
    from spmm_tpu_torch import parallel

    mesh = _cpu_mesh()
    t0 = time.perf_counter()
    with _watch() as seen:
        C = getattr(parallel, name)(S, B, mesh, **kw)
    return {"C": C.host(), "ms": (time.perf_counter() - t0) * 1e3, **seen}


def plan_task(S, B, **kw) -> dict:
    """``spgemm_dist_plan`` then ``spgemm_dist_exec`` twice: both global
    CSRs, what ``_watch`` saw during the plan and during the two execs,
    where the plan's blocks lie, and the host ms of the plan and of the
    second exec."""
    from spmm_tpu_torch.parallel import spgemm_dist_exec, spgemm_dist_plan

    mesh = _cpu_mesh()
    t0 = time.perf_counter()
    with _watch() as at_plan:
        plan = spgemm_dist_plan(S, B, mesh, **kw)
    t1 = time.perf_counter()
    with _watch() as at_exec:
        Cs = [spgemm_dist_exec(plan, mesh).host()]
        t2 = time.perf_counter()
        Cs.append(spgemm_dist_exec(plan, mesh).host())
    ms = {"plan": (t1 - t0) * 1e3, "exec": (time.perf_counter() - t2) * 1e3}
    return {"C": Cs, "plan": at_plan, "exec": at_exec, "pattern": plan.pattern, "ms": ms,
            "devices": sorted({x.device.type for x in plan.aligned_cols + plan.aligned_vals})}


def exec_raw_task(S, B, **kw) -> dict:
    """``spgemm_dist_exec(as_csr=False)`` over this rank's plan: the chunk
    outputs' leading axes, their live entries (rows in the shard's row
    space) and the plan's tail rows' products."""
    from spmm_tpu_torch.ops.slab_spgemm import _pull_chunks
    from spmm_tpu_torch.parallel import spgemm_dist_exec, spgemm_dist_plan

    mesh = _cpu_mesh()
    plan = spgemm_dist_plan(S, B, mesh, **kw)
    outs = spgemm_dist_exec(plan, mesh, as_csr=False)
    r, c, v = _pull_chunks([tuple(x[0] for x in o) for o in outs])
    cat = lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt)
    return {"lead": sorted({x.shape[0] for o in outs for x in o}), "schedule": plan.schedule,
            "rows": cat(r, np.int64), "cols": cat(c, np.int64), "vals": cat(v, np.float32),
            "tail": plan.tail}


def revalue_task(S, B, S2, B2, bad, **kw) -> dict:
    """A plan of (S, B), revalued with (S2, B2) and executed: the global CSR,
    both plans' pattern modes and what ``_watch`` saw during the plan and
    during the revalue; then the ValueError of a revalue with ``bad`` = (S,
    B) of another structure."""
    from spmm_tpu_torch.parallel import spgemm_dist_exec, spgemm_dist_plan, spgemm_dist_revalue

    mesh = _cpu_mesh()
    with _watch() as at_plan:
        plan = spgemm_dist_plan(S, B, mesh, **kw)
    with _watch() as seen:
        plan2 = spgemm_dist_revalue(plan, S2, B2, mesh)
    C = spgemm_dist_exec(plan2, mesh).host()
    try:
        spgemm_dist_revalue(plan, *bad, mesh)
        err = None
    except ValueError as e:
        err = str(e)
    return {"C": C, "patterns": (plan.pattern, plan2.pattern), "plan": at_plan, "revalue": seen,
            "error": err}


def big_task(A, B, *, max_exp_pad: int | None = None, **kw) -> dict:
    """``spgemm_dist_big``: the global host CSR (or the ValueError's
    message), the call's host ms and what ``_watch`` saw.  ``max_exp_pad`` sets
    ``slab_spgemm._MAX_EXP_PAD`` on this rank for the call (a test's
    monkeypatch does not reach a spawned rank)."""
    from spmm_tpu_torch.ops import slab_spgemm
    from spmm_tpu_torch.parallel import spgemm_dist_big

    old = slab_spgemm._MAX_EXP_PAD
    if max_exp_pad is not None:
        slab_spgemm._MAX_EXP_PAD = max_exp_pad
    mesh = _cpu_mesh()
    t0 = time.perf_counter()
    try:
        with _watch() as seen:
            C = spgemm_dist_big(A, B, mesh, **kw)
    except ValueError as e:
        return {"error": str(e)}
    finally:
        slab_spgemm._MAX_EXP_PAD = old
    return {"C": C.host(), "ms": (time.perf_counter() - t0) * 1e3, **seen}


def b_off_the_mesh_task(S, A, B_meta) -> list:
    """The ValueError of each new SpGEMM entry point given a B held in
    tensors on another device type than the mesh's."""
    from spmm_tpu_torch import parallel

    mesh = _cpu_mesh()
    msgs = []
    for call in (lambda: parallel.spgemm_dist_halo(S, B_meta, mesh),
                 lambda: parallel.spgemm_dist_halo_exchange(S, B_meta, mesh),
                 lambda: parallel.spgemm_dist_plan(S, B_meta, mesh, b_sharded=True),
                 lambda: parallel.spgemm_dist_big(A, B_meta, mesh)):
        try:
            call()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def dryrun_task(n: int, *, ell: bool = False) -> dict:
    """``entry.dryrun_multichip(n, device="cpu")``: what this rank printed
    (rank 0 prints the lines), its products through the ELL pack (K2's route,
    its plain version here), and whether JAX got loaded.  ``ell`` lowers
    ``ops.spmm``'s pack threshold to 0 for the call, so the ring's tiny
    products take that route, as a full-size shard's do."""
    from spmm_tpu_torch.entry import dryrun_multichip

    spmm_mod = importlib.import_module("spmm_tpu_torch.ops.spmm")  # the module, not ops.spmm
    thr, real = spmm_mod.AUTO_ELL_THRESHOLD, spmm_mod.ell_spmm
    calls = []
    spmm_mod.ell_spmm = lambda *a, **k: calls.append(1) or real(*a, **k)
    if ell:
        spmm_mod.AUTO_ELL_THRESHOLD = 0
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            dryrun_multichip(n, device="cpu")
    finally:
        spmm_mod.AUTO_ELL_THRESHOLD, spmm_mod.ell_spmm = thr, real
    return {"out": out.getvalue(), "ell_products": len(calls), "jax": "jax" in sys.modules}


def dryrun_error_task(n: int) -> str | None:
    """The RuntimeError of ``dryrun_multichip(n)`` on a group of another
    world size."""
    from spmm_tpu_torch.entry import dryrun_multichip

    try:
        dryrun_multichip(n, device="cpu")
    except RuntimeError as e:
        return str(e)
    return None


def hang_task() -> int:
    """Rank 0 never joins the all-reduce the others wait in."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        return 0
    t = torch.ones(1)
    dist.all_reduce(t)
    return int(t)
