"""Least bytes of each sparse product: every input byte read once and every
output byte written once, in the device form a CSR operand has (int32
``indptr`` and ``indices``, values of ``val`` bytes), whatever a kernel
reads again.  Where the work depends on the data, the count is of what these
inputs need: only the rows of a dense operand that some entry reads."""

from __future__ import annotations


def csr_bytes(nrow: int, nnz: int, *, val: int = 4, values: bool = True) -> int:
    """A CSR matrix: ``indptr``, ``indices`` and (unless ``values`` is
    False, as for a pattern that is only read) its values."""
    return 4 * (nrow + 1) + nnz * (4 + (val if values else 0))


def spgemm(a_nrow: int, a_nnz: int, c_nnz: int, *, b_nrow: int | None = None,
           b_nnz: int | None = None, val: int = 4) -> int:
    """C = A·B: A and B read, C written; B counted apart only when it is not
    A (``b_nrow`` / ``b_nnz`` None: B is A)."""
    total = csr_bytes(a_nrow, a_nnz, val=val) + csr_bytes(a_nrow, c_nnz, val=val)
    if b_nrow is not None:
        total += csr_bytes(b_nrow, b_nnz, val=val)
    return total


def spmm(m: int, nnz: int, k: int, read_rows: int, *, val: int = 4) -> int:
    """Y (m × k) = A (m rows, nnz) · X: A read, the ``read_rows`` rows of X
    that A's columns name read, Y written."""
    return csr_bytes(m, nnz, val=val) + (read_rows + m) * k * val


def sddmm(m: int, nnz: int, k: int, dy_rows: int, x_rows: int, *, val: int = 4) -> int:
    """The values' gradient of Y = A·X: for each entry (i, j),
    dY[i]·X[j]; A's structure read, the rows of dY and X that it names
    read, one value per entry written."""
    return csr_bytes(m, nnz, values=False) + (dy_rows + x_rows) * k * val + nnz * val


def dense_loss(m: int, k: int, *, val: int = 4) -> int:
    """loss = Σ Y² of Y (m × k) and its gradient dY = 2·Y: Y read once,
    dY written once, the scalar loss not counted."""
    return 2 * m * k * val
