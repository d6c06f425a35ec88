"""The port's ``utils/serialize.py`` against the JAX package's.

Mirrors the three container round trips of ``tests/test_cli_serialize.py``,
then carries state across: a file the JAX package writes loads in the port
to the same container, and back.  A JAX ``SpgemmPlan`` file (TPU-folded
tables) is refused with a clear ValueError.
"""

import numpy as np
import pytest
import torch

from spmm_tpu.config import Config as JConfig
from spmm_tpu.formats import bsr as jbsr
from spmm_tpu.formats import ell as jell
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.ops.slab_spgemm import spgemm_plan as j_spgemm_plan
from spmm_tpu.preprocess import preprocess as jpreprocess
from spmm_tpu.utils import serialize as jser

from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats import csr_to_bsr, ell_pack, to_coo
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.ops.ell_spmm import ell_spmm
from spmm_tpu_torch.preprocess import preprocess, unpack_to_csr
from spmm_tpu_torch.utils.serialize import load, save

from torch_parity import assert_same, one_torch_thread  # noqa: F401  (autouse)


def test_serialize_roundtrip_csr(tmp_path):
    A = tsyn.webgraph_like(500, 3000, seed=0)
    p = tmp_path / "a.npz"
    save(p, A)
    B = load(p)
    assert type(B).__name__ == "CSR"
    assert B.shape == A.shape and B.nnz == A.nnz
    np.testing.assert_array_equal(B.indices, A.indices)
    np.testing.assert_allclose(B.data, A.data)


def test_serialize_roundtrip_blocked(tmp_path):
    A = tsyn.webgraph_like(800, 5000, seed=1)
    P = preprocess(A, Config(region_budget=200))
    p = tmp_path / "p.npz"
    save(p, P)
    Q = load(p)
    assert Q.nregions == P.nregions and Q.ngroups == P.ngroups
    np.testing.assert_array_equal(Q.row_perm, P.row_perm)
    np.testing.assert_array_equal(Q.cols_local, P.cols_local)
    ref = A.to_scipy()
    ref.sort_indices()
    assert (unpack_to_csr(Q).to_scipy() != ref).nnz == 0


def test_serialize_roundtrip_ell(tmp_path):
    A = tsyn.webgraph_like(600, 4000, seed=2)
    E = ell_pack(A)
    p = tmp_path / "e.npz"
    save(p, E)
    E2 = load(p)
    B = np.random.default_rng(0).standard_normal((600, 8)).astype(np.float32)
    Y = ell_spmm(E2.to("cpu"), torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(Y, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_tensor_leaves_save_as_numpy(tmp_path):
    A = tsyn.webgraph_like(300, 1500, seed=3)
    save(tmp_path / "t.npz", A.to("cpu"))
    assert_same(load(tmp_path / "t.npz"), A)


@pytest.mark.parametrize("kind", ["COO", "CSR", "BSR", "ELL", "BlockedCSR"])
def test_jax_file_loads_in_port_and_back(tmp_path, kind):
    """A container written by the JAX package loads in the port as the
    port's own build of it, and the port's file loads in the JAX package as
    the JAX build."""
    from spmm_tpu.formats.containers import to_coo as j_to_coo

    Aj, A = jsyn.webgraph_like(700, 4200, seed=5), tsyn.webgraph_like(700, 4200, seed=5)
    built = {
        "COO": (lambda: j_to_coo(Aj), lambda: to_coo(A)),
        "CSR": (lambda: Aj, lambda: A),
        "BSR": (lambda: jbsr.csr_to_bsr(Aj), lambda: csr_to_bsr(A)),
        "ELL": (lambda: jell.ell_pack(Aj), lambda: ell_pack(A)),
        "BlockedCSR": (lambda: jpreprocess(Aj, JConfig(region_budget=300)),
                       lambda: preprocess(A, Config(region_budget=300))),
    }[kind]
    obj_j, obj = built[0](), built[1]()
    jser.save(tmp_path / "from_jax.npz", obj_j)
    assert_same(load(tmp_path / "from_jax.npz"), obj)
    save(tmp_path / "from_port.npz", obj)
    assert_same(jser.load(tmp_path / "from_port.npz"), obj_j)


def test_jax_plan_file_is_refused(tmp_path):
    Aj = jsyn.webgraph_like(300, 1500, seed=6)
    jser.save(tmp_path / "plan.npz", j_spgemm_plan(Aj, Aj))
    with pytest.raises(ValueError, match="JAX package"):
        load(tmp_path / "plan.npz")
