"""The graph-transformer layer of UniMP (Shi et al., IJCAI 2021, "Masked
Label Prediction: Unified Message Passing Model for Semi-Supervised
Classification"; PyTorch Geometric's ``TransformerConv``) over an ELL pack,
and a stack of them with a linear head.

For each head h of H heads of width d, with N(i) row i's columns in A::

    q_i = W_q^h x_i + b_q^h,  k_j = W_k^h x_j + b_k^h,  v_j = W_v^h x_j + b_v^h
    s_ij = q_i · k_j / sqrt(d)                        (ops.ell_sddmm: K3)
    α_ij = softmax_{j in N(i)} s_ij                   (ops.ell_edge_softmax)
    out_i = W_skip x_i + b_skip + concat_h Σ_j α_ij v_j   (ops.ell_spmm: K2)

Departures from PyG's ``TransformerConv`` (``concat=True``,
``root_weight=True``): no edge features and no β gate (its defaults
``edge_dim=None``, ``beta=False``), no attention dropout.  The pack is A's
pattern (``ell_pack`` of A with its values 1): E's values only mark edges.

The heads take one ``ops.ell_sddmm``, ``ops.ell_edge_softmax`` and
``ops.ell_spmm`` each (H launches of K3 and of K2 at k = d a layer): K2 and K3
read one value per slot, so a product that read H values a slot would need a
kernel of its own.  Q, K and V come from one product with the three weights
and are laid out head-major, (3, H, n, d), so that each head's rows are
contiguous, as K2 and K3 read them.  The ops are looked up on
``spmm_tpu_torch.ops`` at each call.
"""

from __future__ import annotations

import math

import torch

from spmm_tpu_torch import ops


class TransformerConv(torch.nn.Module):
    """One layer: ``forward(E, x)`` for the pattern pack E (n × n) and node
    features x (n, ``in_features``) gives (n, ``heads * head_dim``)."""

    def __init__(self, in_features: int, heads: int, head_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        width = heads * head_dim
        kw = {"device": device, "dtype": dtype}
        self.lin_query = torch.nn.Linear(in_features, width, **kw)
        self.lin_key = torch.nn.Linear(in_features, width, **kw)
        self.lin_value = torch.nn.Linear(in_features, width, **kw)
        self.lin_skip = torch.nn.Linear(in_features, width, **kw)

    def forward(self, E, x: torch.Tensor) -> torch.Tensor:
        n, H, d = x.shape[0], self.heads, self.head_dim
        lins = (self.lin_query, self.lin_key, self.lin_value)
        w = torch.cat([lin.weight for lin in lins])
        b = torch.cat([lin.bias for lin in lins])
        # head-major, and split by one unbind, whose backward is one stack
        # (a view per head would give each head's gradient a whole-size copy)
        qkv = torch.addmm(b, x, w.t()).view(n, 3 * H, d).transpose(0, 1).contiguous().unbind(0)
        heads = []
        for h in range(H):
            s = ops.ell_sddmm(E, qkv[h], qkv[H + h])
            a = ops.ell_edge_softmax(E, s, scale=1.0 / math.sqrt(d))
            heads.append(ops.ell_spmm(a, qkv[2 * H + h], accum_dtype=x.dtype))
        return torch.addmm(torch.cat(heads, 1), x, self.lin_skip.weight.t()) + self.lin_skip.bias


class GraphTransformer(torch.nn.Module):
    """``layers`` TransformerConv layers with ReLU between them and a linear
    head to ``classes`` logits: ``forward(E, x)`` gives (n, ``classes``)."""

    def __init__(self, in_features: int, heads: int, head_dim: int, layers: int, classes: int, *,
                 device=None, dtype=None):
        super().__init__()
        width = heads * head_dim
        self.layers = torch.nn.ModuleList(
            TransformerConv(in_features if i == 0 else width, heads, head_dim, device=device, dtype=dtype)
            for i in range(layers))
        self.head = torch.nn.Linear(width, classes, device=device, dtype=dtype)

    def forward(self, E, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(E, x)
            if i + 1 < len(self.layers):
                x = torch.relu(x)
        return self.head(x)
