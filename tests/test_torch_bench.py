"""The port's benchmark (``bench_torch.py``) and its scaling run
(``spmm_tpu_torch/utils/scaling.py``) on the CPU, at small sizes made from
seeds.

The counts the benchmark reports (the ELL padding, the packed format's
regions and v8 groups, A×A's nnz, the BSR block count, the projected
8-shard balance) must equal what the JAX package's own functions and scipy
give on the same inputs: counts exactly, the balance within 1e-12.  The
entry point runs in a subprocess: one JSON line, a SIGTERM that still
prints it, and a run without a card that fails naming ``device="cpu"``.
Times taken here are the plain versions' on the CPU: no device metric.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from spmm_tpu.config import Config as JConfig
from spmm_tpu.formats import synthetic as jsyn
from spmm_tpu.formats.bsr import csr_to_bsr as j_csr_to_bsr
from spmm_tpu.formats.ell import ell_pack as j_ell_pack
from spmm_tpu.ops import slab_spgemm as js
from spmm_tpu.parallel.partition import partition_rows as j_partition_rows
from spmm_tpu.parallel.spgemm_spmd import _per_shard_sizing as j_per_shard_sizing
from spmm_tpu.preprocess import preprocess as j_preprocess

from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats import synthetic as tsyn
from spmm_tpu_torch.utils import scaling

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402

N, NNZ = 4096, 24_000
BSR_SMALL = (2048, 256, 0.25)


@pytest.fixture(scope="module")
def graph():
    return tsyn.webgraph_like(N, NNZ, seed=0), jsyn.webgraph_like(N, NNZ, seed=0)


@pytest.fixture(scope="module")
def bench_line(graph):
    """The headline, the SpGEMM section and the kernels section (with the
    ``--full`` measurements) on the CPU."""
    A, _ = graph
    b = bench_torch.Bench(budget_s=600.0)
    pre_ms, P = bench_torch.bench_preprocess(A, Config(), iters=1)
    bench_torch.record_headline(b, A, pre_ms, P, float("nan"))
    bench_torch.bench_spgemm(b, A, "cpu")
    bench_torch.bench_kernels(b, A, P, "cpu", full=True, bsr_shape=BSR_SMALL)
    return b.result


def test_headline_counts_match_jax(graph, bench_line):
    _, Aj = graph
    Pj = j_preprocess(Aj, JConfig())
    assert bench_line["value"] > 0 and bench_line["vs_baseline"] is None
    assert bench_line["nnz"] == Aj.nnz and bench_line["n"] == N
    assert bench_line["regions"] == Pj.nregions
    assert bench_line["v8_groups"] == Pj.ngroups


def test_ell_padding_and_bsr_blocks_match_jax(graph, bench_line):
    _, Aj = graph
    assert bench_line["ell_padding_factor"] == j_ell_pack(Aj).padded_nnz / Aj.nnz
    Bj = j_csr_to_bsr(jsyn.banded_random(*BSR_SMALL, seed=3), (8, 128))
    assert bench_line["bsr_nblocks"] == Bj.nblocks


def test_spgemm_out_nnz_and_shard_balance_match_scipy_and_jax(graph, bench_line):
    A, Aj = graph
    As = A.to_scipy()
    assert bench_line["spgemm_out_nnz"] == (As @ As).nnz
    W = js.DEFAULT_SEG_W
    cl = tuple(sorted({js._round_up(c, W) for c in js.DEFAULT_CLASSES}))
    _, counts8, _, _ = j_per_shard_sizing(j_partition_rows(Aj, 8), Aj, W, cl)
    exp8 = (np.asarray(counts8)[:, : len(cl)] * np.asarray(cl)[None, :]).sum(axis=1)
    assert abs(bench_line["spgemm_shard_balance_8"] - exp8.mean() / exp8.max()) <= 1e-12


def test_sections_report_times_and_no_device_shares_on_the_cpu(bench_line):
    """Every time is in the line; the roofline and attainable shares, which
    hold only for the card, are not."""
    for key in ("spgemm_ms", "spgemm_plan_ms", "spgemm_warm_ms", "spgemm_chain_ms", "spmm_ell_k128_ms",
                "spmv_ell_ms", "bsr_spmm_k128_ms", "bsr_spmv_ms", "spmm_ell_k32_ms", "spmv_csr_pack_ms",
                "spmv_csr_ms", "spmm_blocked_k128_ms", "spmm_csr_k128_ms", "spmm_csr_raw_k128_ms",
                "spmv_csr_raw_ms"):
        assert bench_line[key] > 0, key
    assert not [k for k in bench_line if k.endswith(("_sol_frac", "_att_frac", "_error"))]


def test_dist_big_section_on_one_gloo_rank():
    """``spgemm_dist_big`` at world size 1 (gloo for the CPU), its nnz held
    to scipy's inside the section; the group is gone afterwards."""
    import torch.distributed as dist

    b = bench_torch.Bench(budget_s=600.0)
    bench_torch.bench_dist_big(b, "cpu", shape=(3000, 18_000, 4))
    G = tsyn.webgraph_like(3000, 18_000, seed=5).to_scipy()
    assert b.result["spgemm_dist_big_nnz_out"] == (G @ G).nnz
    assert b.result["spgemm_dist_big_pieces"] == 4 and b.result["spgemm_dist_big_ms"] > 0
    assert not dist.is_initialized()
    assert "MASTER_PORT" not in os.environ


def test_suite_section_reports_each_stand_in():
    b = bench_torch.Bench(budget_s=600.0)
    suite = {"small": (3000, 18_000), "web-Google": (1, 1), "smaller": (2000, 10_000)}
    bench_torch.bench_suite(b, Config(), "cpu", suite=suite)
    for name in ("small", "smaller"):
        assert b.result[f"{name}_preprocess_ms"] > 0 and b.result[f"{name}_spgemm_ms"] > 0
    assert not [k for k in b.result if k.startswith("web-Google")]


def test_gate_lists_what_the_deadline_skips():
    b = bench_torch.Bench(budget_s=10.0)
    assert b.gate("fits", 5) and not b.gate("too long", 60)
    assert b.result["skipped"] == ["too long"] and not b.failed()
    b.result["kernel_error"] = "ValueError()"
    assert b.failed()


# ---- the scaling run ---------------------------------------------------------


def test_scaling_curve_at_one_and_two_ranks():
    out = scaling.scaling_curve(2000, 12_000, iters=1, rank_counts=(1, 2), device="cpu")
    A = tsyn.webgraph_like(2000, 12_000, seed=0).to_scipy()
    assert out["scaling_n"] == 2000 and out["scaling_nnz"] == A.nnz
    assert out["scaling_out_nnz"] == (A @ A).nnz  # every count gave this nnz
    for nd in (1, 2):
        assert out[f"spgemm_scaling_cpu_{nd}"] > 0 and out[f"spgemm_overhead_flatness_{nd}"] > 0
    assert out["spgemm_overhead_flatness_1"] == 1.0
    assert "scaling_truncated_at" not in out


def test_scaling_module_prints_one_line_and_stops_at_its_budget():
    proc = subprocess.run([sys.executable, "-m", "spmm_tpu_torch.utils.scaling", "--n", "2000", "--nnz", "12000",
                           "--iters", "1", "--budget", "0", "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["scaling_truncated_at"] == 2  # the first count always runs
    assert out["spgemm_scaling_cpu_1"] > 0 and "spgemm_scaling_cpu_2" not in out


def test_scaling_defaults_to_the_card_and_fails_without_one_naming_cpu():
    """The host mesh only when asked for: without a card the default raises
    before any rank starts, in the function and in its ``python -m`` form."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        scaling.scaling_curve(2000, 12_000, iters=1, rank_counts=(1,))
    proc = subprocess.run([sys.executable, "-m", "spmm_tpu_torch.utils.scaling", "--n", "2000", "--nnz", "12000"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert 'device="cpu"' in proc.stderr


# ---- the roofline arguments and the card ---------------------------------------


def test_attainable_kwargs_charge_the_tables_the_plan_builds(graph):
    """The SpGEMM bound's port-specific arguments are the plan's own sizes:
    the B2 table's bytes and row bytes, and one (L, R_pad * L) per chunk
    block of its aligned cache."""
    import torch

    from spmm_tpu_torch.ops import slab_spgemm as ss

    A, _ = graph
    W = ss.DEFAULT_SEG_W
    cl = ss._norm_classes(ss.DEFAULT_CLASSES, W)
    plan = ss.spgemm_plan(A, A, device="cpu")
    kw = ss.attainable_kwargs(ss._sizing(A, A, W, cl), A.shape[0], 123, cl, W=W)
    b2 = plan.b2_cols
    assert kw["b2_table_bytes"] == b2.numel() * b2.element_size()
    assert kw["b2_row_bytes"] == b2.shape[1] * b2.element_size() == W * 4
    assert kw["chunk_slots"] == tuple((int(c.shape[1]), int(c.numel())) for c in plan.aligned_cols)
    assert kw["geom_table_bytes"] == A.shape[0] * torch.empty((), dtype=torch.int64).element_size()
    assert kw["nrow_b"] == A.shape[0] and kw["out_nnz"] == 123


@pytest.mark.parametrize("name, shares", [("NVIDIA H100 80GB HBM3", True), ("NVIDIA H100 PCIe", False),
                                          ("NVIDIA A100-SXM4-80GB", False)])
def test_card_line_and_shares_by_the_cards_name(monkeypatch, name, shares):
    """On a card without a datasheet entry the run goes on with no shares
    (``chip_of`` is None, it does not raise); the power limit is asked of
    the card the run is on."""
    import torch

    from spmm_tpu_torch.formats import containers
    from spmm_tpu_torch.ops.roofline import H100_SXM
    from spmm_tpu_torch.utils import primitives

    monkeypatch.setattr(containers, "compute_device", lambda device="cuda": torch.device(device))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    monkeypatch.setattr(primitives, "power_limit", lambda dev: f"{name}, 700.00 W on {dev}")
    dev = torch.device("cuda", 1)
    assert bench_torch.chip_of(dev) is (H100_SXM if shares else None)
    assert bench_torch._card(dev) == {"device": name, "power_limit": f"{name}, 700.00 W on cuda:1"}
    assert bench_torch.chip_of(torch.device("cpu")) is None
    assert bench_torch._card(torch.device("cpu")) == {"device": "cpu"}


# ---- the entry point in a subprocess -----------------------------------------


def _bench(args, budget: str, **kw):
    env = dict(os.environ, BENCH_BUDGET_S=budget, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, os.path.join(ROOT, "bench_torch.py"), *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def test_entry_point_prints_one_line_and_lists_skipped_sections():
    proc = _bench(["--quick", "--device", "cpu", "--no-kernels", "--no-suite", "--no-scaling"], "40")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["value"] > 0 and res["device"] == "cpu"
    assert res["skipped"] == ["spgemm"]  # its gate asks for 150 s
    assert not [k for k in res if k.endswith("_error") or k in ("error", "interrupted")]


def test_sigterm_still_prints_the_line_and_exits_nonzero():
    proc = _bench(["--quick", "--device", "cpu", "--no-suite", "--no-scaling"], "600")
    t0 = time.monotonic()
    for line in proc.stderr:  # wait for the headline
        if line.startswith("preprocess:") or time.monotonic() - t0 > 100:
            break
    time.sleep(0.5)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode != 0
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["interrupted"] == "SIGTERM" and res["value"] > 0


def test_without_a_card_the_default_device_fails_naming_cpu():
    proc = _bench(["--quick", "--no-scaling"], "60")
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    res = json.loads(out.strip().splitlines()[-1])
    assert 'device="cpu"' in res["error"] and res["value"] is None


def test_import_installs_no_handler_and_starts_no_thread():
    code = ("import signal, sys, threading\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "before = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGALRM), threading.active_count())\n"
            "import bench_torch\n"
            "after = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGALRM), threading.active_count())\n"
            "assert before == after, (before, after)\n"
            "assert signal.alarm(0) == 0\n"
            "assert not [t for t in threading.enumerate() if t.name == 'bench-watchdog']\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)
    # nor in this process, which imported it at the top
    assert not [t for t in threading.enumerate() if t.name == "bench-watchdog"]
