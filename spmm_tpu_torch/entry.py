"""The single-chip forward step of the flagship path (port of
``__graft_entry__.py: entry``): blocked SpMM over the preprocessed
BlockedCSR, each v8-group bucket through kernel K2.

    fn, args = entry("cuda")
    Y = fn(*args)          # (4096, 128) fp32, rows in original order
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.config import Config
from spmm_tpu_torch.formats.synthetic import webgraph_like
from spmm_tpu_torch.ops.blocked import blocked_slab_view, blocked_spmm_slab
from spmm_tpu_torch.preprocess import preprocess


def entry(device="cuda"):
    """``(fn, (P, B, view))`` with ``fn = blocked_spmm_slab``: the same graph,
    config, seeds and k = 128 as the JAX package's ``entry()``, every
    tensor on ``device``."""
    A = webgraph_like(4096, 24576, seed=0)
    P = preprocess(A, Config(region_budget=2048, panel_rows=512)).to(device)
    view = blocked_slab_view(P)  # pack once: each bucket of v8 groups is one K2 slab
    B = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4096, 128)).astype(np.float32)
    ).to(device)
    return blocked_spmm_slab, (P, B, view)
