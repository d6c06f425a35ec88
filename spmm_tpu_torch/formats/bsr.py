"""BSR (block-sparse row) format (port of ``spmm_tpu/formats/bsr.py``).

The reference mandate includes BSR/block-compressed storage (BASELINE.json
configs 3-4).  Blocks default to (8, 128), the JAX package's shape, so both
packages hold the same blocks.

Every block row holds at least one block (a zero block is inserted for empty
block rows).  The TPU kernel needed that to initialise every output tile; the
CUDA kernel writes every tile anyway, and the blocks are kept so that both
packages build the same BSR.

The 8-row block granularity is the same one the reference's v8 packing
targets for SIMD (reference: PreProcessing/v8sort.h:64,194;
serial_newblock_clock.cpp:366-399; SURVEY.md §2.7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

from spmm_tpu_torch.formats.containers import CSR, Container

Array = Any


@dataclasses.dataclass(frozen=True)
class BSR(Container):
    data: Array  # (nblocks, bm, bn) float
    block_cols: Array  # (nblocks,) int32 — block-column index
    block_rows: Array  # (nblocks,) int32 — block-row index (sorted, CSR order)
    block_indptr: Array  # (nbrows + 1,) int32
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    nblocks: int
    nnz: int  # logical nnz

    @property
    def nbrows(self) -> int:
        return int(self.block_indptr.shape[0] - 1)

    def to_dense(self) -> np.ndarray:
        h = self.host()
        bm, bn = self.block_shape
        m = self.nbrows * bm
        n_pad = (self.shape[1] + bn - 1) // bn * bn
        out = np.zeros((m, n_pad), dtype=np.asarray(h.data).dtype)
        for b in range(self.nblocks):
            r, c = int(h.block_rows[b]), int(h.block_cols[b])
            out[r * bm : (r + 1) * bm, c * bn : (c + 1) * bn] += np.asarray(h.data[b])
        return out[: self.shape[0], : self.shape[1]]


def csr_to_bsr(A: CSR, block_shape: Tuple[int, int] = (8, 128)) -> BSR:
    """Host conversion: bucket nonzeros into (bm, bn) blocks (dense storage
    per touched block), inserting one zero block for empty block rows."""
    bm, bn = block_shape
    h = A.host()
    m, n = A.shape
    nbrows = (m + bm - 1) // bm
    lens = np.asarray(h.row_lengths(), dtype=np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = np.asarray(h.indices[: A.nnz], dtype=np.int64)
    dat = np.asarray(h.data[: A.nnz])

    br, bc = rows // bm, cols // bn
    key = br * ((n + bn - 1) // bn) + bc
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_key, block_of = np.unique(key_s, return_inverse=True)
    nbcols = (n + bn - 1) // bn
    ubr = (uniq_key // nbcols).astype(np.int64)
    ubc = (uniq_key % nbcols).astype(np.int64)

    # insert zero blocks for empty block rows
    present = np.zeros(nbrows, dtype=bool)
    present[ubr] = True
    missing = np.nonzero(~present)[0]
    all_br = np.concatenate([ubr, missing])
    all_bc = np.concatenate([ubc, np.zeros(len(missing), np.int64)])
    reorder = np.lexsort((all_bc, all_br))
    all_br, all_bc = all_br[reorder], all_bc[reorder]
    nblocks = len(all_br)
    # map original uniq block ids to their post-insert positions
    inv_reorder = np.empty(nblocks, dtype=np.int64)
    inv_reorder[reorder] = np.arange(nblocks)
    block_pos = inv_reorder[: len(ubr)]

    data = np.zeros((nblocks, bm, bn), dtype=dat.dtype)
    bidx = block_pos[block_of]
    np.add.at(data, (bidx, (rows % bm)[order], (cols % bn)[order]), dat[order])

    block_indptr = np.zeros(nbrows + 1, dtype=np.int64)
    np.add.at(block_indptr, all_br + 1, 1)
    np.cumsum(block_indptr, out=block_indptr)

    return BSR(
        data=data,
        block_cols=all_bc.astype(np.int32),
        block_rows=all_br.astype(np.int32),
        block_indptr=block_indptr.astype(np.int32),
        shape=(m, n),
        block_shape=(bm, bn),
        nblocks=nblocks,
        nnz=A.nnz,
    )
