"""Graph-transformer training traffic: one call is a full-batch training step
of the program's graph transformer (``spmm_tpu_torch.nn.GraphTransformer``:
``layers`` TransformerConv layers of ``heads`` × ``head_dim``, ReLU between
them, a linear head to ``classes`` logits) over the configuration's graph:
the forward pass, the mean cross-entropy over the train nodes, the gradient
of the loss with respect to every weight, and ``loss.item()``; no optimizer
step, no dropout, so every call computes the same step.

Parameters: ``layers``, ``in_features``, ``heads``, ``head_dim``,
``classes``, ``train_nodes`` (min(train_nodes, n) distinct nodes drawn from
the seed), ``values`` ("ones": the graph's links).  The weights (PyTorch's
``Linear`` ranges, U(±1/√fan_in)), X (standard normal, float32), the labels
and the train nodes are drawn from the run's seed on the device; the pack is
the program's ELL pack of the graph, built in set-up."""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from portbench import judge as J
from portbench.counts import attention as nbytes
from portbench.gen import Graph, make_graph
from portbench.gen.undirected import undirected_powerlaw
from portbench.reference.graph_transformer import loss_of, param_names, train_step

#: the limits of the numbers compared (PERF.md gives the readings they were set from)
LIMITS = {"loss_err": 1e-6, "logits_err": 1e-4, "grad_err": 1e-3}
KEEP = 3
WARM_CALLS = 2


@dataclasses.dataclass
class State:
    graph: object
    traffic: dict
    X: torch.Tensor
    labels: torch.Tensor
    train: torch.Tensor
    model: object
    E: object
    device: torch.device
    params: dict = dataclasses.field(default_factory=dict)  #: the weights by name, kept for the judge


@dataclasses.dataclass
class StepOut:
    loss: float
    logits: torch.Tensor
    grads: dict  #: the gradient of each weight, by name


def setup(config, traffic, seed, device):
    # the program's attention ops first: a program without them fails here,
    # before the graph is made
    from spmm_tpu_torch.nn.graph_attention import GraphTransformer
    from spmm_tpu_torch.ops import ell_edge_softmax, ell_sddmm  # noqa: F401
    from spmm_tpu_torch.formats.containers import CSR
    from spmm_tpu_torch.formats.ell import ell_pack

    dev = torch.device(device)
    g = _graph(config, seed, traffic["values"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = GraphTransformer(traffic["in_features"], traffic["heads"], traffic["head_dim"], traffic["layers"],
                             traffic["classes"], device=dev)
    with torch.no_grad():
        for lin in model.modules():
            if isinstance(lin, torch.nn.Linear):
                bound = lin.in_features ** -0.5
                lin.weight.uniform_(-bound, bound, generator=gen)
                lin.bias.uniform_(-bound, bound, generator=gen)
    X = torch.randn((g.n, traffic["in_features"]), generator=gen, device=dev, dtype=torch.float32)
    labels = torch.randint(0, traffic["classes"], (g.n,), generator=gen, device=dev)
    train = torch.randperm(g.n, generator=gen, device=dev)[: min(traffic["train_nodes"], g.n)].sort().values
    E = ell_pack(CSR(data=g.data, indices=g.indices, indptr=g.indptr, shape=(g.n, g.n), nnz=g.nnz)).to(dev)
    st = State(g, traffic, X, labels, train, model, E, dev,
               {name: p.detach() for name, p in model.named_parameters()})
    for _ in range(WARM_CALLS):
        call(st)
    return st


def _graph(config, seed, values) -> Graph:
    """The configuration's graph: an ``undirected_powerlaw`` one made here
    (its structure from the configuration's structure seed, its values the
    links), any other through the benchmark's generators."""
    gen = dict(config["generator"])
    if gen.pop("name") != "undirected_powerlaw":
        return make_graph(config, seed, values)
    if values != "ones":
        raise ValueError(f"an undirected_powerlaw graph takes values 'ones', not {values!r}")
    gen.setdefault("seed", 0)
    indptr, indices = undirected_powerlaw(**gen)
    return Graph(indptr=indptr, indices=indices, data=np.ones(len(indices), np.dtype(config["dtype"])),
                 n=len(indptr) - 1)


def call(st: State) -> StepOut:
    logits = st.model(st.E, st.X)
    loss = loss_of(logits, st.labels, st.train)
    names, params = zip(*st.model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return StepOut(loss.item(), logits.detach(), dict(zip(names, grads)))


def counts(st: State) -> dict:
    g, t = st.graph, st.traffic
    least = nbytes.step(g.n, g.nnz, layers=t["layers"], in_features=t["in_features"], heads=t["heads"],
                        head_dim=t["head_dim"], classes=t["classes"], train_nodes=int(st.train.numel()),
                        col_rows=int((np.bincount(g.indices, minlength=g.n) > 0).sum()),
                        row_rows=int((np.diff(g.indptr) > 0).sum()))
    return {"attn_least_bytes": float(least)}


def release(st: State) -> None:
    st.E = st.model = None  # the pack, its memoized tables and the module go
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(st: State, device, dtype):
    g, t = st.graph, st.traffic
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return train_step(tt(g.indptr), tt(g.indices), st.X.to(device), {k: v.to(device) for k, v in st.params.items()},
                      st.labels.to(device), st.train.to(device), heads=t["heads"], head_dim=t["head_dim"],
                      dtype=dtype)


def judge(st: State, kept, device) -> list:
    ref = _reference(st, device, torch.float64)
    logits_scale = torch.clamp(ref["logits"].abs(), min=float(ref["logits"].square().mean().sqrt()))
    names = param_names(st.traffic["layers"])
    checks = []
    for _, out in kept:
        grad = max((J.scaled_err(out.grads[n], ref["grads"][n], ref["grad_scales"][n]) if out.grads.get(n) is not None
                    else float("inf") for n in names), default=float("inf"))
        checks += [
            J.Check("loss_err", abs(out.loss - float(ref["loss"])) / abs(float(ref["loss"])), LIMITS["loss_err"]),
            J.Check("logits_err", J.scaled_err(out.logits, ref["logits"], logits_scale), LIMITS["logits_err"]),
            J.Check("grad_err", grad, LIMITS["grad_err"]),
        ]
    return J.worst(checks)


def control(st: State, device) -> StepOut:
    """The step by the reference in bfloat16, in the program's form."""
    r = _reference(st, device, torch.bfloat16)
    return StepOut(float(r["loss"]), r["logits"].float(), {n: g.float() for n, g in r["grads"].items()})
