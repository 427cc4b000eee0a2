"""Debug pretty-printer for small CSR matrices.

≡ ``printCSR`` (final/utils.c:14-45): ASCII dense dump with optional block
rulers every ``block`` rows/cols — the reference's visual-inspection tool for
tiny matrices and blocked-format debugging.
"""
from __future__ import annotations

import io

from ..formats.bcsr import BCSR

__all__ = ["format_csr", "print_csr"]


def format_csr(mat: BCSR, block: int | None = None) -> str:
    n, m = mat.shape
    if n * m > 1_000_000:
        raise ValueError(f"matrix {mat.shape} too large to pretty-print")
    dense = mat.to_dense()
    out = io.StringIO()
    for i in range(n):
        if block and i % block == 0 and i > 0:
            n_seps = (m - 1) // block  # column rulers inserted below
            out.write("-" * (2 * (m + n_seps) - 1) + "\n")
        cells = []
        for j in range(m):
            if block and j % block == 0 and j > 0:
                cells.append("|")
            cells.append("1" if dense[i, j] else ".")
        out.write(" ".join(cells) + "\n")
    return out.getvalue()


def print_csr(mat: BCSR, block: int | None = None) -> None:
    print(format_csr(mat, block))
