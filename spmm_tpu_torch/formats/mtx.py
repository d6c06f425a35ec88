"""MatrixMarket (.mtx) ingest (port of ``spmm_tpu/formats/mtx.py``).

Replacement for the reference's iostream reader
(reference: serial_newblock_clock.cpp:47-124).  Exact contract reproduced in
``values="pattern"`` mode (SURVEY.md §2.1):

- ``%`` comment lines are skipped; the first data line's field count
  classifies the file (2 = pattern, 3 = coordinate-with-values);
- all values are forced to 1.0 regardless of file contents (the reference
  reads and discards them, serial_newblock_clock.cpp:75-76,84,96-98), so the
  numeric ground truth is the 0/1 pattern matrix;
- 1-based indices become 0-based; within a row nonzeros keep file order; no
  dedup; ``symmetric`` headers are NOT expanded (the stored triangle only).

``values="native"`` additionally reads real values, and ``expand_symmetric=True``
mirrors the off-diagonal triangle — capabilities the reference lacks but a
general SpMM framework needs.

Parsing backends, fastest first: the C++ native parser (spmm_tpu_torch.native),
then a numpy split-based parser.
"""

from __future__ import annotations

import io
import os
from typing import Literal, Tuple

import numpy as np

from spmm_tpu_torch.formats.containers import COO, CSR, to_csr


def _parse_header(first_line: bytes) -> Tuple[str, str]:
    """Returns (field, symmetry) from a %%MatrixMarket banner, with defaults."""
    field, symmetry = "real", "general"
    if first_line.startswith(b"%%MatrixMarket"):
        toks = first_line.decode("ascii", "replace").lower().split()
        for t in toks[2:]:
            if t in ("real", "integer", "pattern", "complex"):
                field = t
            if t in ("general", "symmetric", "skew-symmetric", "hermitian"):
                symmetry = t
    return field, symmetry


def _numpy_parse(body: bytes, num_fields: int, num_lines: int) -> np.ndarray:
    toks = body.split()
    want = num_lines * num_fields
    if len(toks) < want:
        raise ValueError(f".mtx truncated: expected {want} tokens, found {len(toks)}")
    arr = np.array(toks[:want], dtype=np.float64)
    return arr.reshape(num_lines, num_fields)


def read_mtx(
    path: str | os.PathLike,
    *,
    values: Literal["pattern", "native"] = "pattern",
    expand_symmetric: bool = False,
    dtype=np.float32,
) -> COO:
    with open(path, "rb") as f:
        raw = f.read()
    return read_mtx_bytes(
        raw, values=values, expand_symmetric=expand_symmetric, dtype=dtype, path=str(path)
    )


def read_mtx_bytes(
    raw: bytes,
    *,
    values: Literal["pattern", "native"] = "pattern",
    expand_symmetric: bool = False,
    dtype=np.float32,
    path: str = "<bytes>",
) -> COO:
    # --- header / comments ---------------------------------------------------
    pos = 0
    first = True
    field, symmetry = "real", "general"
    size_line = None
    while pos < len(raw):
        eol = raw.find(b"\n", pos)
        if eol < 0:
            eol = len(raw)
        line = raw[pos:eol]
        if first:
            field, symmetry = _parse_header(line)
            first = False
        if line.startswith(b"%") or not line.strip():
            pos = eol + 1
            continue
        size_line = line
        pos = eol + 1
        break
    if size_line is None:
        raise ValueError(f"{path}: no size line found")
    dims = size_line.split()
    if len(dims) < 3:
        raise ValueError(f"{path}: bad size line {size_line!r}")
    nrow, ncol, num_lines = int(dims[0]), int(dims[1]), int(dims[2])

    body = raw[pos:]
    # classify by the first data line's field count (reference behavior,
    # serial_newblock_clock.cpp:51-58) — more robust than trusting the banner.
    first_data_eol = body.find(b"\n")
    probe = body[: first_data_eol if first_data_eol > 0 else len(body)]
    num_fields = len(probe.split()) if probe.split() else 2
    num_fields = max(2, min(num_fields, 4))

    # --- native fast path -----------------------------------------------------
    from spmm_tpu_torch.native import parse_coordinate_body

    table = parse_coordinate_body(body, num_fields, num_lines)
    if table is None:
        table = _numpy_parse(body, num_fields, num_lines)

    row = table[:, 0].astype(np.int64) - 1
    col = table[:, 1].astype(np.int64) - 1
    if values == "native" and num_fields >= 3 and field != "pattern":
        dat = table[:, 2].astype(dtype)
    else:
        dat = np.ones(num_lines, dtype=dtype)

    if expand_symmetric and symmetry in ("symmetric", "hermitian", "skew-symmetric"):
        off = row != col
        r2, c2 = col[off], row[off]
        d2 = -dat[off] if symmetry == "skew-symmetric" else dat[off]
        row = np.concatenate([row, r2])
        col = np.concatenate([col, c2])
        dat = np.concatenate([dat, d2])

    if len(row) and (row.min() < 0 or col.min() < 0 or row.max() >= nrow or col.max() >= ncol):
        raise ValueError(f"{path}: indices out of bounds for shape ({nrow}, {ncol})")

    return COO(
        row=row.astype(np.int32),
        col=col.astype(np.int32),
        data=dat,
        shape=(nrow, ncol),
        nnz=int(len(row)),
    )


def read_mtx_csr(path, **kw) -> CSR:
    """Ingest straight to CSR with the reference's build semantics
    (file order within rows, no dedup)."""
    return to_csr(read_mtx(path, **kw), sort_within_row=False, sum_duplicates=False)


def write_mtx(path, m: COO, *, pattern: bool = False, comment: str = "") -> None:
    """Write a COO matrix as MatrixMarket coordinate (1-based)."""
    h = m.host()
    with open(path, "w") as f:
        kind = "pattern" if pattern else "real"
        f.write(f"%%MatrixMarket matrix coordinate {kind} general\n")
        if comment:
            for ln in comment.splitlines():
                f.write(f"% {ln}\n")
        f.write(f"{m.shape[0]} {m.shape[1]} {m.nnz}\n")
        row = np.asarray(h.row[: m.nnz], dtype=np.int64) + 1
        col = np.asarray(h.col[: m.nnz], dtype=np.int64) + 1
        buf = io.StringIO()
        if pattern:
            np.savetxt(buf, np.stack([row, col], 1), fmt="%d %d")
        else:
            dat = np.asarray(h.data[: m.nnz], dtype=np.float64)
            np.savetxt(buf, np.stack([row, col, dat], 1), fmt="%d %d %.17g")
        f.write(buf.getvalue())
