"""Matrix Market ingest and egest for pattern matrices.

Counterpart of ``binary_spgemm_tpu/io/mmio.py``.  The ingest semantics that
make results bit-exact with the reference's ``readCOO``:

* only the first two whitespace-separated fields of each entry line are read
  (value columns are skipped);
* 1-based indices become 0-based;
* with ``transpose=True`` (the default) entries are grouped by the file's
  *second* index and the stored columns are the file's *first* index: the
  result is the CSR of the transpose of the file's matrix;
* within a row, entries keep file order and duplicates are not merged;
* ``symmetric`` files are expanded only on request (``expand_symmetric``).

The entry body is parsed and written by the native host tier
(:mod:`..native`: a parallel C parser over an mmap of a large file, the
row filter of a sharded read fused into the parse, a C formatter);
:func:`_parse_numpy` and :func:`_format_pairs_numpy` are the numpy
branches the tests hold it against.  A ``.gz`` suffix reads and writes gzip
transparently.
"""
from __future__ import annotations

import contextlib
import gzip
import io
import mmap
import os

import numpy as np

from .. import native
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


# bodies of files this large are parsed from an mmap: the OS pages the file
# in while the parallel parser streams through it
MMAP_BYTES = 16 << 20


@contextlib.contextmanager
def _open_body(path):
    """Yield ``(banner, (n_rows, n_cols, nnz), body)`` of a coordinate file:
    the header from a prefix read grown until it holds the size line, the
    entry body as bytes, or as a memoryview over an mmap of a large file
    (over the decompressed bytes of a ``.gz``), released on exit."""
    raw = None
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as gz:
            raw = gz.read()
    view = mm = None
    with (io.BytesIO(raw) if raw is not None else open(path, "rb")) as f:
        size = len(raw) if raw is not None else os.fstat(f.fileno()).st_size
        head = f.read(1 << 16)
        while True:
            nl = head.find(b"\n")
            if nl >= 0:
                break
            if len(head) >= size:
                raise ValueError("missing Matrix-Market banner line")
            head += f.read(len(head))
        banner = read_banner(head[:nl].decode("ascii", errors="replace"))
        if banner.format != "coordinate":
            raise ValueError(
                f"only coordinate format is supported, got {banner.format}"
            )
        # size line: the first non-blank line after the banner that is not
        # a comment
        pos = nl + 1
        while True:
            nl = head.find(b"\n", pos)
            if nl < 0 and len(head) < size:
                head += f.read(len(head))
                continue
            line = head[pos:] if nl < 0 else head[pos:nl]
            pos = len(head) if nl < 0 else nl + 1
            s = line.strip()
            if s and not s.startswith(b"%"):
                break
            if nl < 0:
                raise ValueError("missing size line")
        shape_nnz = tuple(int(tok) for tok in s.split()[:3])
        if raw is not None:
            view = memoryview(raw)  # head is a prefix of raw
            body = view[pos:]
        elif size >= MMAP_BYTES:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            view = memoryview(mm)
            body = view[pos:]
        else:
            body = head[pos:] + f.read()
    try:
        yield banner, shape_nnz, body
    finally:
        if view is not None:
            body.release()
            view.release()
        if mm is not None:
            mm.close()


def _fields(banner: MMBanner) -> int:
    """Fields an entry line holds; only the first two are read."""
    return {"pattern": 2, "complex": 4}.get(banner.field, 3)


def _parse_numpy(body, nnz: int, fields: int) -> tuple[np.ndarray, np.ndarray]:
    """The numpy branch of :func:`..native.parse_pairs`: 1-based ``(rows,
    cols)`` int64 of ``nnz`` entries."""
    data = np.array(bytes(body).split(), dtype=np.float64) if nnz else np.zeros(0)
    if nnz and data.size % fields != 0:
        raise ValueError(
            f"entry count {data.size} not divisible by {fields} fields/line"
        )
    data = data.reshape(-1, fields) if nnz else data.reshape(0, 2)
    if nnz and data.shape[0] != nnz:
        raise ValueError(f"expected {nnz} entries, found {data.shape[0]}")
    return data[:, 0].astype(np.int64), data[:, 1].astype(np.int64)


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
    (one process's slice of a sharded ingest): the filter runs inside the
    parse, so the process holds only its own entries."""
    if row_range is not None and expand_symmetric:
        raise ValueError(
            "row_range with expand_symmetric is not supported (mirrored "
            "entries cross the row filter); expand first, then slice"
        )
    if row_range is not None:
        lo, hi = (int(x) for x in row_range)
        if lo < 0 or hi < lo:
            raise ValueError(f"row_range {row_range} is not an interval of rows")
    with _open_body(path) as (banner, (n_rows, n_cols, nnz), body):
        fields = _fields(banner)
        if not nnz:
            rows = cols = np.zeros(0, np.uint32)
        elif row_range is not None:
            # the result's row is the file's second field under transpose
            # semantics, the first otherwise
            rows, cols = native.parse_pairs_filtered(
                body, nnz, fields, 1 if transpose else 0, lo + 1, hi + 1)
        else:
            rows, cols = native.parse_pairs(body, nnz, fields)
    rows = rows.astype(np.int64) - 1
    cols = cols.astype(np.int64) - 1

    if banner.symmetry == "symmetric" and expand_symmetric:
        off = rows != cols
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))

    if row_range is not None:
        if transpose:
            cols = cols - lo
            shape = (n_rows, hi - lo)  # swapped by from_coo(transpose=True)
        else:
            rows = rows - lo
            shape = (hi - lo, n_cols)
        return BCSR.from_coo(rows, cols, shape, transpose=transpose)
    return BCSR.from_coo(rows, cols, (n_rows, n_cols), transpose=transpose)


def _format_pairs_numpy(rows: np.ndarray, cols: np.ndarray) -> bytes:
    """The numpy branch of :func:`..native.format_pairs`."""
    return _savetxt([np.asarray(rows, np.int64) + 1, np.asarray(cols, np.int64) + 1],
                    "%d %d")


def _savetxt(columns, fmt: str) -> bytes:
    out = io.BytesIO()
    np.savetxt(out, np.column_stack(columns), fmt=fmt)
    return out.getvalue()


def _write(path, mat: BCSR, field: str, comment: str | None, body: bytes) -> None:
    with _open(path, "wb") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n".encode())
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n".encode())
        f.write(f"{mat.n_rows} {mat.n_cols} {mat.nnz}\n".encode())
        f.write(body)


def write_pattern(path, mat: BCSR, *, comment: str | None = None) -> None:
    """Write a boolean pattern matrix as ``coordinate pattern general``:
    the banner, ``comment`` lines, the size line, then 1-based ``row col``
    pairs."""
    rows, cols = mat.to_coo()
    _write(path, mat, "pattern", comment, native.format_pairs(rows, cols))


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
    _write(path, mat, "integer", comment,
           _savetxt([rows.astype(np.int64) + 1, cols.astype(np.int64) + 1, values],
                    "%d %d %d"))
