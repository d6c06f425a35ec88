"""The two grad-B routes that read A where it is stored, and K2's row map, at
small sizes on the CPU (their plain versions; the kernels are held against
these on the card by ``tests/test_torch_cuda.py``).

- K1 on Aᵀ: ``bsr_spmm_transposed_reference`` (A's own blocks transposed,
  then the ordered sum by block column) against ``jax.grad`` of the JAX
  package's BSR product and scipy's Aᵀ·dY, for block shapes with bn below,
  at and above 128; and the transposed kernel's plan, run step by step in
  numpy as the kernel walks it, against the same Aᵀ·dY.
- K2's maps: ``ell_slabs_spmm_reference`` with ``out_rows`` and a value
  index against numpy; the transposed pack with the forward's row map
  (pieces of cut rows, empty rows) against ``jax.grad`` of the JAX
  ``ell_spmm`` and scipy; ``ell_spmm`` (row map, leftover and empty rows)
  against ``spmm_tpu.ops.ell_spmm``, forward, ``B.grad`` and the slab values'
  gradient.

Tolerances: 1e-5 of max for fp32 products against fp64 references, 1e-4
for gradients (as ``tests/test_torch_autodiff.py``), 1e-12 in fp64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmm_tpu.formats import bsr as jbsr
from spmm_tpu.formats import ell as jell
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops.ell_spmm import ell_spmm as j_ell_spmm
from spmm_tpu.ops.pallas_bsr import bsr_spmm_xla as j_bsr_spmm_xla

from spmm_tpu_torch import ops
from spmm_tpu_torch.formats.convert import from_numpy
from spmm_tpu_torch.ops import bsr_kernel, ell_kernel

from torch_parity import rhs, one_torch_thread  # noqa: F401  (autouse)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


# ---- K1 on Aᵀ -------------------------------------------------------------------


@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32), (4, 256), (8, 24)])
def test_bsr_transposed_plain_matches_jax_grad_and_scipy(block_shape):
    A = jsyn.banded_random(301, 96, 0.3, seed=31)
    Aj = jbsr.csr_to_bsr(A, block_shape)
    B0 = rhs(-(-301 // block_shape[1]) * block_shape[1], 128, 32)
    dY = rhs(301, 128, 33)
    _, vjp = jax.vjp(lambda B: j_bsr_spmm_xla(Aj.device(), B), jnp.asarray(B0))
    (gj,) = vjp(jnp.asarray(dY))
    At = from_numpy(Aj)
    g = ops.bsr_spmm_transposed_reference(At, torch.from_numpy(dY))
    assert g.shape == (301, 128) and g.dtype == torch.float32
    _close(g.numpy(), np.asarray(gj)[:301], 1e-5)
    _close(g.numpy(), A.to_scipy().T @ dY.astype(np.float64), 1e-5)
    assert torch.equal(ops.bsr_spmm_transposed(At, torch.from_numpy(dY)), g)  # the CPU route


def test_bsr_transposed_plain_fp64():
    A = jsyn.banded_random(200, 64, 0.4, seed=34, dtype=np.float64)
    At = from_numpy(jbsr.csr_to_bsr(A, (8, 128)))
    dY = np.random.default_rng(35).standard_normal((200, 128))
    g = ops.bsr_spmm_transposed_reference(At, torch.from_numpy(dY))
    assert g.dtype == torch.float64
    _close(g.numpy(), A.to_scipy().T @ dY, 1e-12)


@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32), (4, 256), (5, 300)])
def test_transposed_plan_walked_as_the_kernel_walks_it(block_shape):
    """Each block once, in groups of 128 // bn block columns (parts of 128
    rows when bn > 128); the sum over each group's union, stage by stage of
    32 depth rows, is Aᵀ·dY."""
    bm, bn = block_shape
    A = jsyn.banded_random(403, 120, 0.3, seed=36)
    Aj = jbsr.csr_to_bsr(A, block_shape)
    n = A.shape[1]
    G, nsub, gptr, ucols, blk = bsr_kernel.transposed_plan(
        Aj.block_rows, Aj.block_cols, -(-n // bn), bm, bn)
    assert G == max(1, 128 // bn) and nsub == -(-bn // 128)
    used = blk[blk >= 0]
    assert sorted(used) == list(range(Aj.nblocks))  # every block once, by index: no copy of values
    dY = rhs(403, 8, 37).astype(np.float64)
    data = np.asarray(Aj.data, np.float64)
    out = np.zeros((-(-n // bn) * bn, 8))
    rows_cta = 128
    for gx in range(len(gptr) - 1):
        for sub in range(nsub):
            base, nU = gptr[gx], gptr[gx + 1] - gptr[gx]
            r = np.arange(rows_cta)  # the CTA's rows
            slot, j = (r // bn, r % bn) if nsub == 1 else (np.zeros_like(r), sub * rows_cta + r)
            live = (slot < G) & (j < bn)
            for vd in range(nU * bm):  # the depth, cut into stages of 32 by the kernel
                u, d = divmod(vd, bm)
                drow = ucols[base + u] * bm + d
                if drow >= 403:
                    continue
                b = np.where(live, blk[base + u, np.minimum(slot, G - 1)], -1)
                ok = b >= 0
                out[(gx * G + slot[ok]) * bn + j[ok]] += data[b[ok], d, j[ok]][:, None] * dY[drow]
    _close(out[:n], A.to_scipy().T @ dY, 1e-12)


# ---- K2's maps ------------------------------------------------------------------


def test_k2_plain_with_row_map_and_value_index():
    rng = np.random.default_rng(40)
    cols = [rng.integers(0, 30, (5, 3)).astype(np.int32), rng.integers(0, 30, (4, 9)).astype(np.int32)]
    flat = rng.standard_normal(100).astype(np.float32)
    vidx = [rng.integers(-1, 100, c.shape).astype(np.int32) for c in cols]
    B = rhs(30, 6, 41)
    out_rows = torch.tensor([11, 2, 7, 0, 5, 9, 1, 3, 4], dtype=torch.int32)
    out = torch.full((12, 6), float("nan"))
    ops.ell_slabs_spmm_reference([torch.from_numpy(c) for c in cols], [torch.from_numpy(v) for v in vidx],
                                 torch.from_numpy(B), out, out_rows=out_rows, values=torch.from_numpy(flat))
    fz = np.concatenate([flat, [0.0]])
    rows = np.concatenate([np.einsum("rl,rlk->rk", fz[v], B[c]) for c, v in zip(cols, vidx)])
    _close(out.numpy()[out_rows.numpy()], rows, 1e-5)
    assert torch.isnan(out[[6, 8, 10]]).all()  # rows no slab row maps to are left alone


@pytest.mark.parametrize("cut", [4, 2048])
def test_transposed_pack_with_row_map_matches_jax_grad(cut):
    """grad B of ``ell_spmm`` through the mapped transposed pack (dY read at
    the original rows, pieces of cut rows joined from scratch rows) against
    ``jax.grad`` of the JAX ``ell_spmm`` and scipy's Aᵀ·dY."""
    A = jsyn.webgraph_like(300, 2400, seed=42)
    Ej = jell.ell_pack(A, max_len=64)
    B0 = rhs(300, 8, 43)
    dY = rhs(300, 8, 44)
    _, vjp = jax.vjp(lambda B: j_ell_spmm(Ej.device(), B), jnp.asarray(B0))
    (gj,) = vjp(jnp.asarray(dY))
    Et = from_numpy(Ej).to("cpu")
    perm = torch.from_numpy(np.asarray(Et.perm))
    out_rows = perm[Et.n_empty : 300 - Et.n_rest_rows].to(torch.int32)
    T = ops.transposed_slabs(Et.cols, 300, "cpu", cut=cut, out_rows=out_rows)
    memo = {("transposed", torch.device("cpu"), 300, "rows"): T}
    g = ops.ell_slabs_spmm_transposed(Et.cols, Et.data, torch.from_numpy(dY), 300, memo=memo,
                                      out_rows=out_rows)
    assert (T.scratch > 0) == (cut == 4) and list(memo) == [("transposed", torch.device("cpu"), 300, "rows")]
    # the leftover rows' share is the gather path's, not the pack's: add it as the JAX side has it
    S = A.to_scipy()
    slab_rows = np.asarray(Et.perm)[Et.n_empty : 300 - Et.n_rest_rows]
    want = S[slab_rows].T @ dY[slab_rows].astype(np.float64)
    _close(g.numpy(), want, 1e-5)
    rest_rows = np.asarray(Et.perm)[300 - Et.n_rest_rows :]
    _close(g.numpy() + S[rest_rows].T @ dY[rest_rows], np.asarray(gj), 1e-4)


@pytest.mark.parametrize("max_len,permute_back", [(2048, True), (16, True), (16, False)])
def test_ell_spmm_row_map_matches_jax(max_len, permute_back):
    """``ell_spmm`` with its row map (and the length-sorted order) against the
    JAX package: forward, ``B.grad`` and the slab values' gradient, leftover
    and empty rows included."""
    A = jsyn.webgraph_like(300, 1500, seed=45)
    Ej = jell.ell_pack(A, max_len=max_len)
    assert Ej.n_empty > 0 and (Ej.n_rest_rows > 0) == (max_len == 16)
    B0 = rhs(300, 8, 46)
    f = lambda B, d: jnp.sum(j_ell_spmm(dataclasses.replace(Ej.device(), data=d), B,
                                        permute_back=permute_back) ** 2)
    yj = np.asarray(j_ell_spmm(Ej.device(), jnp.asarray(B0), permute_back=permute_back))
    gBj, gDj = jax.grad(f, argnums=(0, 1))(jnp.asarray(B0), tuple(jnp.asarray(d) for d in Ej.data))
    Et = from_numpy(Ej).to("cpu")
    data = tuple(d.clone().requires_grad_() for d in Et.data)
    B = torch.from_numpy(B0).requires_grad_()
    y = ops.ell_spmm(dataclasses.replace(Et, data=data), B, permute_back=permute_back)
    _close(y.detach().numpy(), yj, 1e-5)
    gB, *gD = torch.autograd.grad((y ** 2).sum(), [B, *data])
    _close(gB.numpy(), np.asarray(gBj), 1e-4)
    for a, b in zip(gD, gDj, strict=True):
        _close(a.numpy(), np.asarray(b), 1e-4)
    if permute_back:
        _close(y.detach().numpy(), A.to_scipy() @ B0.astype(np.float64), 1e-5)


def test_row_maps_cover_every_row_once():
    A = jsyn.webgraph_like(400, 2400, seed=47)
    Et = from_numpy(jell.ell_pack(A, max_len=32)).to("cpu")
    from spmm_tpu_torch.ops.ell_spmm import _row_maps

    out_rows, rest_rows, zero_rows = _row_maps(Et, torch.device("cpu"))
    assert out_rows.dtype == torch.int32
    both = torch.cat([out_rows.long(), rest_rows, zero_rows]).sort().values
    assert torch.equal(both, torch.arange(400))
    assert _row_maps(Et, torch.device("cpu"))[0] is out_rows  # memoized beside the work tables


def test_sddmm_plain_reads_dy_through_the_row_map():
    rng = np.random.default_rng(48)
    cols = [torch.from_numpy(rng.integers(0, 20, (4, 3)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 20, (2, 5)).astype(np.int32))]
    B = torch.from_numpy(rhs(20, 6, 49))
    dY = torch.from_numpy(rhs(9, 6, 50))
    out_rows = torch.tensor([8, 0, 3, 5, 1, 7], dtype=torch.int32)
    got = ell_kernel.ell_slabs_sddmm_reference(cols, dY, B, out_rows=out_rows)
    want = ell_kernel.ell_slabs_sddmm_reference(cols, dY[out_rows.long()], B)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


# ---- K3's slot-major walk ------------------------------------------------------


def _transpose_reduce(v, tpr):
    """The kernel's transpose-reduction over each group of ``tpr`` lanes of a
    warp: v (32, ns) partials per lane; lane t ends with the sum of value
    t >> log2(tpr / ns) over its group."""
    lanes = np.arange(32)
    tl = lanes % tpr
    ns = v.shape[1]
    h, o = ns // 2, tpr // 2
    while h >= 1:
        up = (tl & o) != 0
        send = np.where(up[:, None], v[:, :h], v[:, h : 2 * h])
        keep = np.where(up[:, None], v[:, h : 2 * h], v[:, :h])
        v = keep + send[lanes ^ o]
        h, o = h // 2, o // 2
    s = v[:, 0]
    o = tpr // ns // 2
    while o >= 1:
        s = s + s[lanes ^ o]
        o //= 2
    return s


def _k3_walk(cols, dY, B, out_rows, vec, tpr_log2, row_keys):
    """K3 as the kernel walks its table (``sddmm_table``): warps over runs of
    slots, the lanes' column and dY-row loads, 8-slot sub-batches of partial
    dot products over each lane's columns, the transpose-reduction and the
    lane that stores each slot.  Returns per slab the values and how often
    each slot was written."""
    tpr = 1 << tpr_log2
    NS, U = min(tpr, ell_kernel.K3_SUB), max(1, ell_kernel.K3_SUB // tpr)
    NSB = max(1, tpr // ell_kernel.K3_SUB)
    step = ell_kernel.k3_step(tpr_log2)
    meta, items = ell_kernel.sddmm_table([c.shape for c in cols], tpr_log2, row_keys=row_keys)
    n, k = B.shape
    units = k // vec
    lanes = np.arange(32)
    gi, tl = lanes // tpr, lanes % tpr
    # lane t's columns: units t, t + tpr, ... of vec columns each
    colmask = np.zeros((32, k), bool)
    for t in range(32):
        for u in range(tl[t], units, tpr):
            colmask[t, u * vec : (u + 1) * vec] = True
    vals = [np.zeros(c.size) for c in cols]
    writes = [np.zeros(c.size, np.int64) for c in cols]
    for s, q in items:
        L, R, row0 = (int(x) for x in meta[s, :3])
        flat_cols = np.clip(cols[s].reshape(-1), 0, n - 1)
        for w in range(ell_kernel.THREADS // 32):
            w0 = int(q) + w * ell_kernel.K3_STEPS * step
            w1 = min(w0 + ell_kernel.K3_STEPS * step, R * L)
            for q0 in range(w0, w1, step):
                slot = q0 + np.arange(U)[:, None] * 32 + lanes[None, :]  # (U, 32): load_step
                ok = slot < w1
                cw = np.where(ok, flat_cols[np.minimum(slot, R * L - 1)], 0)
                yw = np.where(ok, out_rows[row0 + np.minimum(slot, R * L - 1) // L], -1)
                outv = np.zeros((U, 32))
                for sb in range(NSB):
                    part = np.zeros((32, ell_kernel.K3_SUB))
                    for j in range(ell_kernel.K3_SUB):
                        src = gi * tpr + sb * NS + j % NS
                        cj, yj = cw[j // NS][src], yw[j // NS][src]
                        prod = dY[np.maximum(yj, 0)] * B[cj] * colmask
                        part[:, j] = np.where(yj >= 0, prod.sum(1), 0.0)
                    if tpr >= ell_kernel.K3_SUB:
                        red = _transpose_reduce(part, tpr)
                        got = red[gi * tpr + (tl % 8) * (tpr // 8)]
                        outv[0] = np.where(tl // 8 == sb, got, outv[0])
                    else:
                        for u in range(U):
                            outv[u] = _transpose_reduce(part[:, u * NS : (u + 1) * NS], tpr)
                vals[s][slot[ok]] = outv[ok]
                np.add.at(writes[s], slot[ok], 1)
    return [v.reshape(c.shape) for v, c in zip(vals, cols)], [w.reshape(c.shape) for w, c in zip(writes, cols)]


@pytest.mark.parametrize("k", [1, 8, 32, 64, 128, 130])
def test_k3_slot_major_walk_matches_jax_vjp(k):
    """K3's slot-major table walked as the kernel walks it, with the
    transpose-reduction's lane-to-slot assignment: every slot written once,
    and the values held to ``jax.vjp`` of the JAX ``ell_spmm`` with respect
    to the slab values (1e-5 of max), dY read through ``ell_spmm``'s row map."""
    from spmm_tpu_torch.ops.ell_spmm import _row_maps, slab_row_keys

    A = jsyn.webgraph_like(400, 2600, seed=51)
    Ej = jell.ell_pack(A, max_len=2048)  # the hub row too
    B0 = rhs(400, k, 52)
    dY = rhs(400, k, 53)
    f = lambda d: j_ell_spmm(dataclasses.replace(Ej.device(), data=d), jnp.asarray(B0))
    (gj,) = jax.jit(lambda d, c: jax.vjp(f, d)[1](c))(tuple(jnp.asarray(d) for d in Ej.data), jnp.asarray(dY))
    Et = from_numpy(Ej).to("cpu")
    out_rows = _row_maps(Et, torch.device("cpu"))[0].numpy()
    cols = [np.asarray(c) for c in Ej.cols]
    assert {c.shape[1] for c in cols} >= {1, 2, 3} and any(c.shape[1] > ell_kernel.SPLIT_L for c in cols)
    vec, tpr_log2 = ell_kernel.lane_layout(k, True)
    got, writes = _k3_walk(cols, dY.astype(np.float64), B0.astype(np.float64), out_rows, vec, tpr_log2,
                           slab_row_keys(Et))
    for g, w, want in zip(got, writes, gj, strict=True):
        assert (w == 1).all()
        if want.size:
            _close(g, np.asarray(want), 1e-5)
