"""Shared pieces of the benchmark's own tests (run from the repository's
root: ``python -m pytest portbench/tests``).  They run on the CPU with the
kernels' plain versions; a test that needs the card carries the ``cuda``
marker and skips without one."""

import json
import os

import pytest
import torch

from portbench import harness

#: a graph small enough for the CPU, made by the same generator as the configurations
TINY = {"generator": {"name": "webgraph_like", "n": 3000, "nnz": 18000}, "dtype": "float32"}
with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as _f:
    BENCHMARK = json.load(_f)
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
#: every traffic mix (each is a cell's)
TRAFFIC = sorted(f[: -len(".json")] for f in os.listdir(os.path.join(harness.HERE, "traffic")))


def tiny_cell(traffic: str) -> harness.Cell:
    """A cell of ``traffic`` over the tiny graph, with the end-to-end
    metrics of the benchmark's cell that runs it."""
    with open(os.path.join(harness.HERE, "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    name = next(w["name"] for w in BENCHMARK["workloads"] if w["traffic"] == traffic)
    e2e = harness.load_cell(name, BENCHMARK).end_to_end
    return harness.Cell(f"tiny.{traffic}", 1, TINY, mix, e2e, [])


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
