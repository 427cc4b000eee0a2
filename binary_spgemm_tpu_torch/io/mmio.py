"""Matrix Market ingest and egest for pattern matrices.

Counterpart of ``binary_spgemm_tpu/io/mmio.py``, its numpy branches (the JAX
package falls back to them where its native parser is not built).  The
ingest semantics that make results bit-exact with the reference's
``readCOO``:

* only the first two whitespace-separated fields of each entry line are read
  (value columns are skipped);
* 1-based indices become 0-based;
* with ``transpose=True`` (the default) entries are grouped by the file's
  *second* index and the stored columns are the file's *first* index: the
  result is the CSR of the transpose of the file's matrix;
* within a row, entries keep file order and duplicates are not merged;
* ``symmetric`` files are expanded only on request (``expand_symmetric``).

A ``.gz`` suffix reads and writes gzip transparently.
"""
from __future__ import annotations

import gzip
import io

import numpy as np

from ..formats.bcsr import BCSR

__all__ = ["MMBanner", "read_banner", "read_pattern", "write_integer", "write_pattern"]


class MMBanner:
    def __init__(self, obj, fmt, field, symmetry):
        self.object = obj
        self.format = fmt
        self.field = field
        self.symmetry = symmetry

    def __repr__(self):
        return (
            f"MMBanner({self.object}, {self.format}, {self.field}, {self.symmetry})"
        )


def read_banner(line: str) -> MMBanner:
    """Parse the ``%%MatrixMarket`` banner line."""
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket":
        raise ValueError(f"not a MatrixMarket banner: {line!r}")
    _, obj, fmt, field, symmetry = parts[:5]
    return MMBanner(obj.lower(), fmt.lower(), field.lower(), symmetry.lower())


def _open(path, mode: str):
    return gzip.open(path, mode) if str(path).endswith(".gz") else open(path, mode)


def read_pattern(
    path,
    *,
    transpose: bool = True,
    expand_symmetric: bool = False,
    row_range: tuple[int, int] | None = None,
) -> BCSR:
    """Read a Matrix Market coordinate file as a boolean pattern matrix.

    ``transpose=True`` reproduces the reference's ingest (see the module
    docstring).  ``expand_symmetric`` mirrors the off-diagonal entries of a
    file declared ``symmetric``; the reference does not, so it is off by
    default.  ``row_range=(lo, hi)`` keeps rows ``[lo, hi)`` of the result
    only, as a ``(hi - lo, cols)`` matrix with row ids shifted by ``-lo``
    (one process's slice of a sharded ingest)."""
    if row_range is not None and expand_symmetric:
        raise ValueError(
            "row_range with expand_symmetric is not supported (mirrored "
            "entries cross the row filter); expand first, then slice"
        )
    with _open(path, "rb") as f:
        raw = f.read()
    with io.BytesIO(raw) as f:
        banner = read_banner(f.readline().decode("ascii", errors="replace"))
        if banner.format != "coordinate":
            raise ValueError(
                f"only coordinate format is supported, got {banner.format}"
            )
        # size line: the first non-blank line after the banner that is not
        # a comment
        while True:
            line = f.readline()
            if not line:
                raise ValueError("missing size line")
            s = line.strip()
            if s and not s.startswith(b"%"):
                break
        n_rows, n_cols, nnz = (int(tok) for tok in s.split()[:3])
        body = f.read()
    # only the first two fields of each entry are used; value columns skipped
    fields_per_line = {"pattern": 2, "complex": 4}.get(banner.field, 3)
    data = np.array(body.split(), dtype=np.float64) if nnz else np.zeros(0)
    if nnz and data.size % fields_per_line != 0:
        raise ValueError(
            f"entry count {data.size} not divisible by "
            f"{fields_per_line} fields/line"
        )
    data = data.reshape(-1, fields_per_line) if nnz else data.reshape(0, 2)
    if nnz and data.shape[0] != nnz:
        raise ValueError(f"expected {nnz} entries, found {data.shape[0]}")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1

    if banner.symmetry == "symmetric" and expand_symmetric:
        off = rows != cols
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))

    if row_range is not None:
        lo, hi = (int(x) for x in row_range)
        key = cols if transpose else rows  # the field that becomes the row
        keep = (key >= lo) & (key < hi)
        rows, cols = rows[keep], cols[keep]
        if transpose:
            cols = cols - lo
            shape = (n_rows, hi - lo)  # swapped by from_coo(transpose=True)
        else:
            rows = rows - lo
            shape = (hi - lo, n_cols)
        return BCSR.from_coo(rows, cols, shape, transpose=transpose)
    return BCSR.from_coo(rows, cols, (n_rows, n_cols), transpose=transpose)


def _write(path, mat: BCSR, field: str, comment: str | None, columns, fmt: str):
    with _open(path, "wb") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n".encode())
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n".encode())
        f.write(f"{mat.n_rows} {mat.n_cols} {mat.nnz}\n".encode())
        np.savetxt(f, np.column_stack(columns), fmt=fmt)


def write_pattern(path, mat: BCSR, *, comment: str | None = None) -> None:
    """Write a boolean pattern matrix as ``coordinate pattern general``:
    the banner, ``comment`` lines, the size line, then 1-based ``row col``
    pairs."""
    rows, cols = mat.to_coo()
    _write(path, mat, "pattern", comment, [rows + 1, cols + 1], "%d %d")


def write_integer(path, mat: BCSR, values, *, comment: str | None = None) -> None:
    """Write a matrix with one integer per entry as ``coordinate integer
    general`` (``spgemm_counts``' multiplicities).  The file reads back
    through :func:`read_pattern` as its support."""
    values = np.asarray(values)
    if values.shape != (mat.nnz,):
        raise ValueError(f"values shape {values.shape} != (nnz,) = ({mat.nnz},)")
    if not np.issubdtype(values.dtype, np.integer):
        raise ValueError(
            f"write_integer requires integer values, got dtype {values.dtype}"
            " (cast explicitly if truncation is intended)"
        )
    rows, cols = mat.to_coo()
    _write(path, mat, "integer", comment, [rows + 1, cols + 1, values], "%d %d %d")
