"""The ordered segment sum that replaced the port's atomic ``index_add_``,
K1's dtype mixes and ``k_tile``, and the port's own native sources.

- ``ops.segments.segment_sum`` against ``jax.ops.segment_sum`` (sorted and
  unsorted ids, ids out of range, fp32 at 1e-5 and fp64 at 1e-12 of max);
- the ordered-sum kernel's work order, walked in numpy as the kernel walks
  it (chunks, lane groups, the pieces' join and the fix-up): every row
  summed once, the sums against ``jax.ops.segment_sum``;
- a CPU mirror of ``tests/test_aux.py::test_spmm_bitwise_deterministic``
  for every product that went through ``index_add_``: two runs equal in
  their bits, and each held against the JAX package (1e-4 of max, as the
  SpMM parity tests);
- ``ops.spmm(BSR, B)`` with fp32 blocks × bf16 B and the reverse, and with
  ``k_tile=256``, against ``bsr_spmm_pallas(..., interpret=True)`` (fp32
  1e-5 of max, bf16 operands widened alike on both sides);
- the native C++ sources: the port's copies equal the JAX package's byte for
  byte, and no file of the port finds or imports ``spmm_tpu``.

On the card the same sums run the kernel ``csrc/segment_sum.cu``;
``tests/test_torch_cuda.py`` reruns each site there.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmm_tpu.config import Config as JConfig
from spmm_tpu.formats import bsr as jbsr
from spmm_tpu.formats import ell as jell
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops import spgemm_sorted as j_spgemm
from spmm_tpu.ops.blocked import blocked_slab_view as j_slab_view
from spmm_tpu.ops.blocked import blocked_spmm_slab as j_blocked_spmm_slab
from spmm_tpu.ops.blocked import blocked_spmm_xla as j_blocked_spmm_xla
from spmm_tpu.ops.ell_spmm import ell_spmm as j_ell_spmm
from spmm_tpu.ops.pallas_bsr import bsr_spmm_pallas, bsr_spmv as j_bsr_spmv
from spmm_tpu.preprocess import preprocess as j_preprocess

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats.convert import from_numpy
from spmm_tpu_torch.ops import segments

from torch_parity import rhs, one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


# ---- the ordered segment sum against jax.ops.segment_sum ----------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12), (np.int64, 0.0)])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("k", [0, 1, 5])
def test_segment_sum_matches_jax(dtype, tol, sort, k):
    rng = np.random.default_rng(7 + k)
    nseg = 40
    ids = rng.integers(-3, nseg + 3, 700)  # ids out of range take no part
    ids[:50] = 17  # one long segment
    if sort:
        ids = np.sort(ids)
    shape = (700,) if k == 0 else (700, k)
    data = (rng.standard_normal(shape) * 100).astype(dtype)
    with jax.enable_x64(dtype != np.float32):
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), nseg,
                                              indices_are_sorted=sort))
    got = segments.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), nseg,
                               indices_are_sorted=sort)
    assert got.dtype == torch.from_numpy(data).dtype and tuple(got.shape) == want.shape
    _close(got.numpy(), want, tol)
    # the plan, once per structure, gives the same bits again
    plan = segments.segment_plan(torch.from_numpy(ids), nseg, indices_are_sorted=sort)
    assert torch.equal(segments.segment_sum(torch.from_numpy(data), plan=plan), got)
    assert not got.numpy()[np.setdiff1d(np.arange(nseg), ids)].any()  # empty segments are zero


def _walk_chunks(rows, offsets, itemsize):
    """The ordered-sum kernel's walk, in numpy (``csrc/segment_sum.cu``):
    chunks of P positions, lane groups of ``ipt`` rows, the pieces of
    segments that cross groups joined by a segmented scan over the groups,
    partials of segments that cross chunks joined by the fix-up in chunk
    order.  ``rows``: the data in position order.  Returns
    the sums, how often each segment was written and how often each
    position was summed (every column tile walks alike, so all columns go
    together)."""
    n, k = rows.shape
    nseg = len(offsets) - 1
    kt, ct, ipt = segments.chunk_layout(k, itemsize)
    G = segments.THREADS // ct
    P = G * ipt
    nchunks = max(1, -(-n // P))
    out = np.zeros((nseg, k), rows.dtype)
    written = np.zeros(nseg, np.int64)
    seen = np.zeros(n, np.int64)
    last_le = lambda x: int(np.searchsorted(offsets, x, "right")) - 1
    empty = offsets[:-1] == offsets[1:]
    written[empty] += 1  # zeroed by the grid-stride pass
    partA, partB, segB = {}, {}, np.full(nchunks, -1)
    IN, ENDS, OUT = 1, 2, 4
    for c in range(nchunks):
        p0, p1 = c * P, min(c * P + P, n)
        if p1 <= p0:
            continue
        fl = np.zeros(G, np.int64)
        I, C, iseg, cseg = {}, {}, {}, {}
        for g in range(G):
            a, b = p0 + g * ipt, min(p0 + g * ipt + ipt, p1)
            if a >= b:
                continue
            s, p = last_le(a), a
            if s < 0:
                p = int(offsets[0])
                s = last_le(p) if p < b else -1
            while 0 <= s < nseg and p < b:
                lo, hi = int(offsets[s]), int(offsets[s + 1])
                e = min(hi, b)
                acc = np.zeros(k, rows.dtype)
                for i in range(p, e):  # in order
                    acc = acc + rows[i]
                seen[p:e] += 1
                if lo < a:
                    fl[g] |= IN | (ENDS if hi <= b else 0)
                    I[g], iseg[g] = acc, s
                elif hi > b:
                    fl[g] |= OUT
                    C[g], cseg[g] = acc, s
                else:
                    out[s] = acc
                    written[s] += 1
                if hi >= b:
                    break
                p = hi
                s = last_le(p)
        # the join: a segmented scan over the groups, Hillis-Steele
        thr = (fl & (IN | ENDS)) == IN
        zero = np.zeros(k, rows.dtype)
        v = [I[g] if thr[g] else C.get(g, zero) for g in range(G)]
        rf = ~thr
        d = 1
        while d < G:
            v = [v[g] if g < d or rf[g] else v[g - d] + v[g] for g in range(G)]
            rf = np.array([rf[g] or (g >= d and rf[g - d]) for g in range(G)])
            d *= 2
        for g in range(G):
            if fl[g] & IN and fl[g] & ENDS:
                tot = v[g - 1] + I[g] if g > 0 else I[g]
                if g > 0 and rf[g - 1]:  # began in this chunk
                    out[iseg[g]] = tot
                    written[iseg[g]] += 1
                else:
                    partA[c] = tot
        g = (p1 - 1 - p0) // ipt
        if fl[g] & OUT or thr[g]:
            if rf[g]:
                partB[c], segB[c] = v[g], (cseg[g] if fl[g] & OUT else iseg[g])
            else:
                partA[c] = v[g]
    for c0 in np.nonzero(segB >= 0)[0]:  # the fix-up
        s = segB[c0]
        c1 = (int(offsets[s + 1]) - 1) // P
        assert c1 > c0
        acc = partB[c0]
        for c in range(c0 + 1, c1 + 1):
            acc = acc + partA.pop(c)
        out[s] = acc
        written[s] += 1
    assert not partA  # every entering piece was joined
    return out, written, seen


@pytest.mark.parametrize("case", ["hub", "edges", "offset0", "unsorted"])
@pytest.mark.parametrize("k,dtype", [(1, np.float32), (5, np.float32), (130, np.float32), (1, np.int64),
                                     (3, np.int64)])
def test_chunk_walk_sums_every_row_once(case, k, dtype):
    """The ordered-sum kernel's chunked walk and fix-up (``_walk_chunks``):
    every position inside a segment is summed exactly once and none outside,
    every segment written exactly once, and the sums held to
    ``jax.ops.segment_sum`` (1e-5 of max in fp32, exact in int64) -- on a
    hub across many chunks, boundaries and empty segments on chunk edges,
    rows before the first and after the last segment, and unsorted ids."""
    rng = np.random.default_rng(k + 100)
    itemsize = np.dtype(dtype).itemsize
    kt, ct, ipt = segments.chunk_layout(k, itemsize)
    P = (segments.THREADS // ct) * ipt
    start, tail = 0, 0
    if case == "hub":
        lens = rng.integers(0, 6, 400)
        lens[123] = 3 * P + 17  # over four chunks
    elif case == "edges":
        lens = np.concatenate([[P, 0, 0, P // 2, P // 2, 0, 3 * P, 0, 7, 3 * P + 5], rng.integers(1, 9, 50),
                               [0, 0, 0]])
    elif case == "offset0":
        lens = rng.integers(0, 3 * P // 50, 100)
        start, tail = P // 3, 77
    else:
        lens = None
    if lens is None:  # unsorted ids with a hub: the plan's order puts them in segment order
        nseg = 60
        ids = rng.integers(-2, nseg + 2, 2 * P + 99)
        ids[rng.choice(ids.size, P + 5, replace=False)] = 17
        plan = segments.segment_plan(torch.from_numpy(ids), nseg)
        offsets, order = plan.offsets.numpy(), plan.order.numpy()
        n = ids.size
    else:
        nseg = lens.size
        offsets = start + np.concatenate([[0], np.cumsum(lens)])
        n, order = int(offsets[-1]) + tail, None
        pos = np.arange(n)
        ids = np.searchsorted(offsets, pos, "right") - 1
        ids[(pos < offsets[0]) | (pos >= offsets[-1])] = -1  # no segment
    data = (rng.standard_normal((n, k)) * 100).astype(dtype) if dtype == np.float32 else \
        rng.integers(-1000, 1000, (n, k)).astype(dtype)
    rows = data if order is None else data[order]
    out, written, seen = _walk_chunks(rows, offsets, itemsize)
    assert (written == 1).all()
    inside = (np.arange(n) >= offsets[0]) & (np.arange(n) < offsets[-1])
    assert (seen[inside] == 1).all() and not seen[~inside].any()
    assert n > P  # more than one chunk: the fix-up ran
    with jax.enable_x64(dtype != np.float32):
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), nseg))
    if dtype == np.float32:
        _close(out, want, 1e-5)
    else:
        np.testing.assert_array_equal(out, want)


def test_segment_sum_gradient_is_the_gather():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 9, 60)
    data = torch.from_numpy(rng.standard_normal((60, 4))).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((9, 4)))
    (gd,) = torch.autograd.grad(segments.segment_sum(data, torch.from_numpy(ids), 9), [data], g)
    np.testing.assert_array_equal(gd.numpy(), g.numpy()[ids])


# ---- the products that used index_add_: bit-identical reruns, held to JAX -----


def _twice(fn):
    a, b = fn(), fn()
    assert torch.equal(a, b), "two runs differ in their bits"
    return a.numpy()


def test_ell_spmm_with_leftover_rows_bitwise_deterministic():
    A = jsyn.webgraph_like(1000, 6000, seed=5)
    Ej = jell.ell_pack(A, max_len=32)  # the hub rows go to the leftover stream
    assert Ej.n_rest_rows > 0
    B = np.random.default_rng(0).standard_normal((1000, 16)).astype(np.float32)
    Et = from_numpy(Ej)
    y = _twice(lambda: ops.ell_spmm(Et, torch.from_numpy(B)))
    _close(y, np.asarray(j_ell_spmm(Ej.device(), jnp.asarray(B))), 1e-4)


def test_blocked_products_bitwise_deterministic():
    A = jsyn.webgraph_like(1500, 9000, seed=23)
    Pj = j_preprocess(A, JConfig(region_budget=512, panel_rows=256))
    B = rhs(1500, 8, 6)
    Pd = Pj.device()
    want = np.asarray(j_blocked_spmm_slab(Pd, jnp.asarray(B), j_slab_view(Pd)))
    Pt = from_numpy(Pj).to("cpu")
    view = ops.blocked_slab_view(Pt)
    assert view[1][0].numel() > 0  # a leftover stream
    _close(_twice(lambda: ops.blocked_spmm_slab(Pt, torch.from_numpy(B), view)), want, 1e-4)
    ev = ops.blocked_exec_view(Pt)
    _close(_twice(lambda: ops.blocked_spmm_xla(Pt, torch.from_numpy(B), view=ev)), want, 1e-4)
    _close(_twice(lambda: ops.blocked_spmm_xla(Pt, torch.from_numpy(B))),
           np.asarray(j_blocked_spmm_xla(Pd, jnp.asarray(B))), 1e-4)


def test_bsr_spmv_bitwise_deterministic():
    A = jsyn.banded_random(500, 64, 0.3, seed=8)
    Aj = jbsr.csr_to_bsr(A, (8, 32))
    x = rhs(1, 500, 9)[0]
    At = from_numpy(Aj)
    y = _twice(lambda: ops.bsr_spmv(At, torch.from_numpy(x)))
    _close(y, np.asarray(j_bsr_spmv(Aj.device(), jnp.asarray(x))), 1e-4)
    _close(y, A.to_scipy() @ x, 1e-4)


def test_spgemm_sorted_value_mode_bitwise_deterministic():
    A = jsyn.webgraph_like(400, 2400, seed=11)
    A = dataclasses.replace(A, data=rhs(1, A.nnz_pad, 12)[0] * (np.arange(A.nnz_pad) < A.nnz))
    At = from_numpy(A)
    C1 = ops.spgemm_sorted(At, At, device="cpu")
    C2 = ops.spgemm_sorted(At, At, device="cpu")
    np.testing.assert_array_equal(np.asarray(C1.data), np.asarray(C2.data))
    Cj = j_spgemm(A, A)
    np.testing.assert_array_equal(np.asarray(C1.indptr), np.asarray(Cj.indptr))
    np.testing.assert_array_equal(np.asarray(C1.indices[: C1.nnz]), np.asarray(Cj.indices[: Cj.nnz]))
    _close(np.asarray(C1.data[: C1.nnz]), np.asarray(Cj.data[: Cj.nnz]), 1e-4)


# ---- K1: dtype mixes and k_tile --------------------------------------------------


@pytest.mark.parametrize("blocks,rhs_dtype", [(np.float32, "bf16"), ("bf16", np.float32)])
def test_bsr_spmm_dtype_mixes_match_pallas(blocks, rhs_dtype):
    A = jsyn.banded_random(300, 64, 0.3, seed=4)
    Aj = jbsr.csr_to_bsr(A, (8, 128))
    B = rhs(300, 128, 5)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # rounded alike
    data = bf(Aj.data) if blocks == "bf16" else Aj.data
    Bv = bf(B) if rhs_dtype == "bf16" else B
    jd = jnp.asarray(data, jnp.bfloat16 if blocks == "bf16" else jnp.float32)
    jB = jnp.asarray(Bv, jnp.bfloat16 if rhs_dtype == "bf16" else jnp.float32)
    want = np.asarray(bsr_spmm_pallas(dataclasses.replace(Aj, data=jd), jB, interpret=True))
    td = torch.from_numpy(np.array(data))
    tB = torch.from_numpy(np.array(Bv))
    At = dataclasses.replace(from_numpy(Aj), data=td.bfloat16() if blocks == "bf16" else td)
    y = ops.spmm(At, tB.bfloat16() if rhs_dtype == "bf16" else tB)
    assert y.dtype == torch.float32
    _close(y.numpy(), want, 1e-5)
    if blocks == np.float32:  # the exact blocks times the rounded B
        _close(y.numpy(), A.to_scipy() @ Bv.astype(np.float64), 1e-5)


def test_bsr_spmm_k_tile_matches_pallas():
    A = jsyn.banded_random(256, 64, 0.3, seed=6)
    Aj = jbsr.csr_to_bsr(A, (8, 128))
    B = rhs(256, 512, 7)
    want = np.asarray(bsr_spmm_pallas(Aj, jnp.asarray(B), k_tile=256, interpret=True))
    At = from_numpy(Aj)
    _close(ops.spmm(At, torch.from_numpy(B), k_tile=256, interpret=True).numpy(), want, 1e-5)
    _close(ops.bsr_spmm(At, torch.from_numpy(B), k_tile=512).numpy(), want, 1e-5)
    for tile, k in ((256, 384), (512, 256)):
        with pytest.raises(ValueError, match=re.escape(f"k={k} must be a multiple of k_tile={tile}")):
            ops.spmm(At, torch.from_numpy(rhs(256, k, 1)), k_tile=tile)
        with pytest.raises(ValueError, match=re.escape(f"k={k} must be a multiple of k_tile={tile}")):
            bsr_spmm_pallas(Aj, jnp.asarray(rhs(256, k, 1)), k_tile=tile, interpret=True)
    with pytest.raises(ValueError, match="k_tile=192"):
        ops.spmm(At, torch.from_numpy(B), k_tile=192)


# ---- the port's own sources -----------------------------------------------------


@pytest.mark.parametrize("name", ["mtxparse.cpp", "preprocess.cpp"])
def test_native_sources_are_the_jax_packages(name):
    from spmm_tpu_torch.native.build import sources

    mine = os.path.join(ROOT, "spmm_tpu_torch", "native", name)
    assert mine in sources()
    with open(mine, "rb") as f, open(os.path.join(ROOT, "spmm_tpu", "native", name), "rb") as g:
        assert f.read() == g.read()


def test_port_neither_finds_nor_imports_the_jax_package():
    bad = re.compile(r"find_spec\(\s*[\"']spmm_tpu[\"']|^\s*(import|from)\s+(spmm_tpu|jax)\b", re.M)
    hits = []
    for base in ("spmm_tpu_torch", "examples"):
        for d, _, files in os.walk(os.path.join(ROOT, base)):
            for f in files:
                if base == "examples" and not f.endswith("_torch.py"):
                    continue
                if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                    with open(os.path.join(d, f), encoding="utf-8") as fh:
                        hits += [f"{f}: {m.group(0).strip()}" for m in bad.finditer(fh.read())]
    with open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8") as fh:
        hits += [f"chip_smoke.py: {m.group(0).strip()}" for m in bad.finditer(fh.read())]
    assert not hits, hits
