"""The port's containers, ingest and generators against the JAX package.

Each test feeds the same numpy inputs (made from a seed) to the ``spmm_tpu``
function and to its ``spmm_tpu_torch`` counterpart and requires equal arrays:
these are host integer/copy operations, so equality is exact.
"""

import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import spmm_tpu.formats as jf
from spmm_tpu.formats import containers as jc
from spmm_tpu.formats import mtx as jmtx
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops.segments import boundary_segments as j_boundary_segments

import spmm_tpu_torch.formats as tf
from spmm_tpu_torch.formats import containers as tc
from spmm_tpu_torch.formats import mtx as tmtx
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops.segments import boundary_segments

from torch_parity import assert_same, one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize(
    "name,args",
    [
        ("webgraph_like", (3000, 18000)),
        ("banded_random", (700, 64, 0.3)),
        ("random_csr", (400, 300, 0.02)),
        ("rmat_matrix", (10,)),
    ],
)
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_bit_identical(name, args, seed):
    a = getattr(jsyn, name)(*args, seed=seed)
    b = getattr(tsyn, name)(*args, seed=seed)
    assert_same(a, b)


def _zipf_numpy20(rng, a, size):
    """numpy 2.0's ``Generator.zipf`` loop, one sample at a time, in Python."""
    am1, out = a - 1.0, []
    b = 2.0**am1
    while len(out) < size:
        U, V = 1.0 - rng.random(), rng.random()
        X = math.floor(math.pow(U, -1.0 / am1))
        if X > float(np.iinfo(np.int64).max) or X < 1:
            continue
        T = math.pow(1.0 + 1.0 / X, am1)
        if V * X * (T - 1.0) / (b - 1.0) <= T / b:
            out.append(X)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("a,size,block", [(1.3, 20_000, 1 << 22), (1.3, 5_000, 777), (2.72, 20_000, 1 << 22),
                                          (1.3, 0, 1 << 22)])
def test_zipf_draws_as_numpy_2_0_whatever_the_release(a, size, block):
    """F11: ``webgraph_like``'s Zipf draws are numpy 2.0's algorithm on the
    generator's own doubles, block by block, and leave the generator where
    that algorithm leaves it (the next draw agrees).  Values past 2^50 may
    differ in their last bits (``np.power`` against C's ``pow``); the
    generators clip them to n."""
    r_ref, r = np.random.default_rng(3), np.random.default_rng(3)
    ref = _zipf_numpy20(r_ref, a, size)
    got = tsyn._zipf(r, a, size, block=block)
    small = ref < 2**50
    assert got.dtype == np.int64 and np.array_equal(got[small], ref[small])
    assert np.allclose(got[~small], ref[~small], rtol=1e-12)
    assert r.random() == r_ref.random()


def test_webgraph_like_does_not_follow_numpys_zipf(monkeypatch):
    """F11: on a numpy whose ``Generator.zipf`` draws otherwise (numpy 2.3's
    does), the port's ``webgraph_like`` still gives this seed's graph, the one
    BASELINE config 5's record was made from: it never calls
    ``Generator.zipf``."""
    want = jsyn.webgraph_like(20_000, 120_000, seed=5)

    class OtherZipf(np.random.Generator):
        def zipf(self, a, size=None):
            raise AssertionError("Generator.zipf was called")

    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: OtherZipf(np.random.PCG64(seed)))
    assert_same(want, tsyn.webgraph_like(20_000, 120_000, seed=5))


@pytest.mark.parametrize("sort_within_row", [True, False])
@pytest.mark.parametrize("sum_duplicates", [True, False])
def test_to_csr_matches_jax(sort_within_row, sum_duplicates):
    rng = np.random.default_rng(3)
    n = 900
    row = rng.integers(0, 60, n).astype(np.int32)  # many duplicates
    col = rng.integers(0, 50, n).astype(np.int32)
    dat = rng.standard_normal(n).astype(np.float32)
    kw = dict(sort_within_row=sort_within_row, sum_duplicates=sum_duplicates)
    a = jc.to_csr(jc.COO(row, col, dat, (60, 50), n), **kw)
    b = tc.to_csr(tc.COO(row, col, dat, (60, 50), n), **kw)
    assert_same(a, b)
    assert_same(jc.to_coo(a), tc.to_coo(b))
    perm = rng.permutation(60)
    assert_same(jc.permute_rows(a, perm), tc.permute_rows(b, perm))


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
@pytest.mark.parametrize("multiple", [1, 8, 128])
def test_pad_rules(leaves, multiple):
    A = tsyn.random_csr(50, 40, 0.05, seed=2)
    Aj = jsyn.random_csr(50, 40, 0.05, seed=2)
    if leaves == "torch":
        A = A.to("cpu")
    P = A.pad(multiple)
    assert P.nnz == A.nnz and P.nnz_pad % multiple == 0 and P.nnz_pad >= A.nnz
    assert isinstance(P.data, torch.Tensor) == (leaves == "torch")
    assert_same(Aj.pad(multiple), P)
    h = P.host()
    assert np.all(h.data[h.nnz :] == 0) and np.all(h.indices[h.nnz :] == 0)
    # shrink back to tight padding
    assert P.pad(1).nnz_pad == max(A.nnz, 1)
    coo = tc.to_coo(A).pad(multiple)
    assert_same(jc.to_coo(Aj).pad(multiple), coo)


@pytest.mark.parametrize("out_size", [0, 1, 37, 300])
def test_boundary_segments_matches_jax(out_size):
    A = tsyn.webgraph_like(200, 1000, seed=4)
    ref = np.asarray(j_boundary_segments(A.indptr, out_size))
    got = boundary_segments(torch.from_numpy(A.indptr), out_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(boundary_segments(A.indptr, out_size).numpy(), ref)
    # the CSR helper: tensor leaves use the same expansion
    np.testing.assert_array_equal(A.to("cpu").row_ids().numpy()[: A.nnz], A.row_ids()[: A.nnz])


@pytest.mark.parametrize("values,pattern", [("pattern", True), ("native", False)])
def test_mtx_roundtrip_matches_jax(tmp_path, values, pattern):
    A = tsyn.banded_random(300, 40, 0.3, seed=5)
    p = tmp_path / "m.mtx"
    tmtx.write_mtx(p, tc.to_coo(A), pattern=pattern, comment="port\ntest")
    assert p.read_text() == _jax_written(tmp_path, A, pattern)
    a = jmtx.read_mtx(p, values=values)
    b = tmtx.read_mtx(p, values=values)
    assert_same(a, b)
    assert_same(jmtx.read_mtx_csr(p, values=values), tmtx.read_mtx_csr(p, values=values))
    if values == "native":
        np.testing.assert_array_equal(tc.to_csr(b).data, A.data)


def _jax_written(tmp_path, A, pattern):
    q = tmp_path / "jax.mtx"
    jmtx.write_mtx(q, jc.to_coo(jf.CSR(A.data, A.indices, A.indptr, A.shape, A.nnz)),
                   pattern=pattern, comment="port\ntest")
    return q.read_text()


def test_read_mtx_symmetric_and_bytes():
    raw = (
        b"%%MatrixMarket matrix coordinate real symmetric\n% c\n"
        b"4 4 4\n1 1 2.0\n2 1 3.0\n4 3 -1.5\n3 2 7\n"
    )
    for kw in ({}, {"values": "native"}, {"values": "native", "expand_symmetric": True}):
        assert_same(jmtx.read_mtx_bytes(raw, **kw), tmtx.read_mtx_bytes(raw, **kw))
    with pytest.raises(ValueError):
        tmtx.read_mtx_bytes(b"3 3 1\n4 1\n")


def _jax_containers():
    A = jsyn.webgraph_like(600, 4000, seed=9)
    from spmm_tpu.preprocess import preprocess
    from spmm_tpu.config import Config

    return {
        "COO": jc.to_coo(A),
        "CSR": A.pad(16),
        "BSR": jf.csr_to_bsr(A, (8, 128)),
        "ELL": jf.ell_pack(A, exact_max=4, step=4, max_len=16),
        "BlockedCSR": preprocess(A, Config(region_budget=256, panel_rows=128)),
    }


@pytest.mark.parametrize("kind", ["COO", "CSR", "BSR", "ELL", "BlockedCSR"])
def test_from_numpy_to_numpy_roundtrip(kind):
    j = _jax_containers()[kind]
    t = tf.from_numpy(j)
    assert type(t).__module__.startswith("spmm_tpu_torch")
    assert_same(j, t)
    # device round trip keeps every leaf
    d = t.to("cpu")
    assert_same(t, d.host())
    back = tf.to_numpy(d, jf)
    assert type(back) is type(j)
    assert_same(j, back)
    assert_same(t, tf.to_numpy(d))


def test_from_numpy_rejects_non_containers():
    with pytest.raises(TypeError):
        tf.from_numpy(np.zeros(3))
    with pytest.raises(TypeError):
        tf.to_numpy(object())


@pytest.mark.parametrize(
    "kw", [{}, {"exact_max": 8, "step": 8, "max_len": 32}, {"exact_max": 4, "step": 4, "max_len": 16}]
)
def test_ell_pack_matches_jax(kw):
    A = tsyn.webgraph_like(1500, 10000, seed=5)
    a = jf.ell_pack(jsyn.webgraph_like(1500, 10000, seed=5), **kw)
    b = tf.ell_pack(A, **kw)
    assert_same(a, b)
    assert a.padded_nnz == b.padded_nnz


@pytest.mark.parametrize(
    "kw", [{}, {"exact_max": 8, "step": 8, "max_len": 32}, {"exact_max": 4, "step": 4, "max_len": 16}]
)
def test_ell_pack_device_matches_host_pack_and_jax(kw):
    """The pack of a tensor-held CSR equals the host pack field for field,
    and the JAX package's ell_pack_device; every leaf is a tensor."""
    import jax.numpy as jnp

    A = tsyn.webgraph_like(1500, 10000, seed=5).pad(8)
    b = tf.ell_pack_device(A.to("cpu"), **kw)
    assert_same(tf.ell_pack(A, **kw), b)
    Aj = jsyn.webgraph_like(1500, 10000, seed=5).pad(8)
    a = jf.ell.ell_pack_device(jc.CSR(*(jnp.asarray(x) for x in (Aj.data, Aj.indices, Aj.indptr)),
                                      Aj.shape, Aj.nnz), **kw)
    assert_same(a, b)
    assert all(isinstance(t, torch.Tensor) for t in (*b.data, *b.cols, b.perm, b.rest.indices))


@pytest.mark.parametrize("block_shape", [(8, 128), (16, 64), (3, 32)])
@pytest.mark.parametrize("gen", ["banded", "sparse"])
def test_csr_to_bsr_matches_jax(block_shape, gen):
    # "sparse" has entirely empty block rows (zero blocks get inserted)
    make = (lambda m: m.banded_random(300, 64, 0.4, seed=8)) if gen == "banded" else (
        lambda m: m.random_csr(512, 512, 0.002, seed=9))
    a = jf.csr_to_bsr(make(jsyn), block_shape)
    b = tf.csr_to_bsr(make(tsyn), block_shape)
    assert_same(a, b)
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())


def test_port_imports_no_jax():
    code = (
        "import sys, spmm_tpu_torch, spmm_tpu_torch.cli, spmm_tpu_torch.formats.convert\n"
        "import spmm_tpu_torch.entry, spmm_tpu_torch.utils.timing, spmm_tpu_torch.utils.profiling\n"
        "import spmm_tpu_torch.ops.roofline, importlib.util\n"
        "import numpy as np\n"
        "from spmm_tpu_torch.formats.synthetic import webgraph_like\n"
        "A = webgraph_like(60, 300, seed=0)\n"
        "runs = {'pagerank': lambda m: m.pagerank(A, iters=2, device='cpu'),\n"
        "        'cg_solver': lambda m: m.cg(m.laplacian_system(A), np.ones(60), iters=2, device='cpu'),\n"
        "        'bfs': lambda m: m.bfs(A, 0, device='cpu'),\n"
        "        'triangle_count': lambda m: m.count_triangles(m.symmetrize(A), device='cpu')}\n"
        "for name, run in runs.items():  # the examples import inside their functions: run each\n"
        "    spec = importlib.util.spec_from_file_location(name + '_torch', f'examples/{name}_torch.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    run(mod)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'spmm_tpu.'))"
        " or m == 'spmm_tpu']\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_bench_and_scaling_import_no_jax():
    """``bench_torch.py``, ``spmm_tpu_torch.utils.scaling`` and
    ``spmm_tpu_torch.utils.dist_big``, imported and run at a tiny size on the
    CPU (their sections import inside their functions), load no ``jax`` and
    no ``spmm_tpu`` module."""
    code = (
        "import sys\n"
        "import bench_torch\n"
        "from spmm_tpu_torch import ops\n"
        "from spmm_tpu_torch.utils import dist_big, scaling\n"
        "from spmm_tpu_torch.config import Config\n"
        "from spmm_tpu_torch.formats.synthetic import webgraph_like\n"
        "A = webgraph_like(600, 3000, seed=0)\n"
        "b = bench_torch.Bench(600.0)\n"
        "ms, P = bench_torch.bench_preprocess(A, Config(), iters=1)\n"
        "bench_torch.record_headline(b, A, ms, P, float('nan'))\n"
        "bench_torch.bench_spgemm(b, A, 'cpu')\n"
        "bench_torch.bench_kernels(b, A, P, 'cpu', bsr_shape=(512, 128, 0.25))\n"
        "assert b.result['spgemm_out_nnz'] > 0 and not b.failed(), b.result\n"
        "ck = dist_big.check_blocks(A, {'C': ops.spgemm(A, A, device='cpu')}, 3, values=False)\n"
        "assert not ck['mismatch'] and ck['ref_nnz'] > 0, ck\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'spmm_tpu.'))"
        " or m == 'spmm_tpu']\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_compile_if_stale_rebuilds_and_raises(tmp_path):
    """The shared builder of both native libraries: no rebuild while the
    library is newer than its sources, a rebuild after a source changes, and a
    failing compile raises with the compiler's message."""
    from spmm_tpu_torch.native.build import compile_if_stale

    src = tmp_path / "f.cpp"
    src.write_text('extern "C" int f() { return 1; }\n')
    lib = str(tmp_path / "out" / "libf.so")
    cmd = ["g++", "-shared", "-fPIC"]
    assert compile_if_stale([str(src)], lib, cmd) == lib
    t0 = os.path.getmtime(lib)
    os.utime(lib, (t0 + 10, t0 + 10))
    compile_if_stale([str(src)], lib, cmd)
    assert os.path.getmtime(lib) == t0 + 10  # fresh: not rebuilt
    src.write_text('extern "C" int f() { return 2; }\n')
    os.utime(src, (t0 + 20, t0 + 20))
    compile_if_stale([str(src)], lib, cmd)
    assert os.path.getmtime(lib) != t0 + 10
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed"):
        compile_if_stale([str(src)], lib, cmd, force=True)
    assert sorted(os.listdir(tmp_path / "out")) == ["libf.so"]  # no temp file left


def test_kernel_build_needs_nvcc():
    from spmm_tpu_torch import kernels

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(force=True)
    assert [os.path.basename(s) for s in kernels.sources()] == [
        "bsr_spmm.cu", "ell_slab_sddmm.cu", "ell_slab_spmm.cu", "errors.cu", "segment_sum.cu", "slab_spgemm.cu"]
