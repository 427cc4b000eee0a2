"""The native host tier: C helpers loaded with ctypes, built at first use.

Counterpart of ``binary_spgemm_tpu/native/``.  ``mmparse.c`` beside this
file is the port's own copy of the JAX package's C source (OpenMP): the
Matrix-Market body parser and formatter, the stable COO->CSR grouping, the
sliced-ELL class partition and table fill, the per-row flop count and the
host engine's three Gustavson products.  Each helper returns the same
arrays as the numpy branch of its caller, which stays beside it as a named
function.

:func:`lib` compiles the source with ``cc`` (or ``gcc``) ``-O3 -fopenmp
-shared -fPIC`` into ``binary_spgemm_tpu_torch/build/``, under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library never loaded.  Each process compiles into a file of its
own and moves it into place with ``os.replace``, so processes that build at
once (test workers, the ranks of a group) never load a half-written
library.  A build or load that fails raises with the compiler's output:
there is no switch that turns the tier off.

A helper returns ``None`` only where its size guard sends the input to the
numpy branch (an entry count past the int32 domain, which the C code
addresses with uint32 row pointers) or where the C code could not allocate
its scratch memory.  The helpers run ``threads()`` OpenMP threads: the
host's cores, divided among the ranks of a group on this machine
(``LOCAL_WORLD_SIZE``, which ``torchrun`` and :mod:`..parallel.launch` set).
Their output does not depend on the thread count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "CFLAGS",
    "class_partition",
    "coo2csr",
    "format_pairs",
    "lib",
    "masked_spgemm_host",
    "parse_pairs",
    "parse_pairs_filtered",
    "row_weight",
    "spgemm_counts_host",
    "spgemm_host",
    "table_fill",
    "threads",
]

SRC = Path(__file__).resolve().parent / "mmparse.c"
BUILD = SRC.parent.parent / "build"
CFLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
COMPILERS = ("cc", "gcc")

_INT32_MAX = int(np.iinfo(np.int32).max)
_UINT32_MAX = int(np.iinfo(np.uint32).max)

_lock = threading.Lock()
_lib = None

_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_longp = ctypes.POINTER(ctypes.c_long)
_long, _int = ctypes.c_long, ctypes.c_int

# name -> (restype, argtypes)
_SIGNATURES = {
    # buffers go as c_void_p: bytes, or a raw address (the mmap path)
    "mm_parse_pairs": (_long, [ctypes.c_void_p, _long, _long, _int, _u32p, _u32p]),
    "mm_parse_pairs_par": (_long, [ctypes.c_void_p, _long, _long, _int, _u32p, _u32p,
                                   _int]),
    "mm_parse_pairs_filtered": (_long, [ctypes.c_void_p, _long, _long, _int, _int,
                                        ctypes.c_uint32, ctypes.c_uint32, _u32p, _u32p,
                                        _long]),
    "mm_format_pairs": (_long, [_u32p, _u32p, _long, ctypes.c_char_p]),
    "coo2csr_stable": (_long, [_u32p, _u32p, _long, _long, _u32p, _u32p]),
    "coo2csr_stable_par": (_long, [_u32p, _u32p, _long, _long, _u32p, _u32p, _u32p,
                                   _u32p, _int]),
    # indptr, n_rows, cols, nnz, class_of_row, pos_in_class, n_classes,
    # out_rows, out_pos, cuts, nthreads
    "ell_class_partition": (_long, [_u32p, _long, _i32p, _long, _i32p, _i32p, _int,
                                    _i32p, _i32p, _longp, _int]),
    # indptr, n_rows, cols, weight, out, nthreads
    "csr_row_weight": (_long, [_u32p, _long, _i32p, _i64p, _i64p, _int]),
    # indptr, n_rows, indices, class_of_row, pos_in_class, tables, widths,
    # sentinel, nthreads
    "ell_table_fill": (_long, [_u32p, _long, _i32p, _i32p, _i32p,
                               ctypes.POINTER(ctypes.c_void_p), _longp, ctypes.c_int32,
                               _int]),
    "spgemm_host": (_long, [_u32p, _i32p, _long, _long, _u32p, _i32p, _u32p, _i32p,
                            _long]),
    "masked_spgemm_host": (_long, [_u32p, _i32p, _u32p, _i32p, _long, _long, _u32p,
                                   _i32p, _u32p, _i32p, _long]),
    "spgemm_counts_host": (_long, [_u32p, _i32p, _long, _long, _u32p, _i32p, _u32p,
                                   _i32p, _i64p, _long]),
}


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CFLAGS).encode())
    return BUILD / f"libmmparse-{digest.hexdigest()[:12]}.so"


def _compiler() -> str:
    for name in COMPILERS:
        found = shutil.which(name)
        if found is not None:
            return found
    raise RuntimeError(
        f"no C compiler ({', '.join(COMPILERS)}) on PATH: the native host tier "
        f"({SRC.name}) cannot be built"
    )


def _build(target: Path) -> None:
    """Compile the source into ``target`` through a file of this process and
    thread, moved into place whole.  Raises with the compiler's output."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CFLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def lib() -> ctypes.CDLL:
    """The loaded library, built from ``mmparse.c`` at first use.  Raises
    if the build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                _build(target)
            loaded = ctypes.CDLL(str(target))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = loaded
        return _lib


def threads() -> int:
    """OpenMP threads a helper runs: the host's cores over the ranks of a
    group on this machine (``LOCAL_WORLD_SIZE``; 1 outside a group)."""
    local = max(int(os.environ.get("LOCAL_WORLD_SIZE", "1")), 1)
    return max((os.cpu_count() or 1) // local, 1)


def _buffer(body):
    """``(address or bytes, length)`` of a parse input: bytes go as they
    are, any other buffer (a memoryview over an mmap) by its address."""
    if isinstance(body, bytes):
        return body, len(body)
    buf = np.frombuffer(body, dtype=np.uint8)
    return buf.ctypes.data, len(buf)


def parse_pairs(body, nnz: int, fields: int):
    """Parse ``nnz`` 'row col [val...]' entries: 1-based ``(rows, cols)``
    uint32 arrays.  Raises ``ValueError`` on malformed or truncated input.
    Bodies of 1 MiB or more take the parallel parser, which hands a body
    whose layout defeats its split to the serial one."""
    lb = lib()
    addr, blen = _buffer(body)
    rows = np.empty(nnz, dtype=np.uint32)
    cols = np.empty(nnz, dtype=np.uint32)
    out = (rows.ctypes.data_as(_u32p), cols.ctypes.data_as(_u32p))
    got = -2
    if blen >= (1 << 20):
        got = lb.mm_parse_pairs_par(addr, blen, nnz, fields, *out, threads())
    if got == -2:
        got = lb.mm_parse_pairs(addr, blen, nnz, fields, *out)
    if got < 0:
        raise ValueError("malformed Matrix-Market entry body")
    if got != nnz:
        raise ValueError(f"expected {nnz} entries, found {got}")
    return rows, cols


def parse_pairs_filtered(body, nnz: int, fields: int, which: int, vlo: int, vhi: int):
    """Parse keeping the entries whose 1-based field ``which`` (0 or 1) lies
    in ``[vlo, vhi)``: two passes (count, then fill exactly-sized arrays),
    so a process never holds the entries it drops.  1-based uint32
    ``(rows, cols)``."""
    lb = lib()
    addr, blen = _buffer(body)
    count = lb.mm_parse_pairs_filtered(addr, blen, nnz, fields, which, vlo, vhi, None,
                                       None, 0)
    if count < 0:
        raise ValueError("malformed Matrix-Market entry body")
    rows = np.empty(count, dtype=np.uint32)
    cols = np.empty(count, dtype=np.uint32)
    got = lb.mm_parse_pairs_filtered(addr, blen, nnz, fields, which, vlo, vhi,
                                     rows.ctypes.data_as(_u32p),
                                     cols.ctypes.data_as(_u32p), count)
    if got != count:
        raise ValueError("malformed Matrix-Market entry body")
    return rows, cols


def format_pairs(rows: np.ndarray, cols: np.ndarray) -> bytes:
    """0-based pairs as 1-based 'row col\\n' ASCII lines."""
    lb = lib()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    cols = np.ascontiguousarray(cols, dtype=np.uint32)
    n = len(rows)
    if len(cols) != n:
        raise ValueError(f"{n} rows but {len(cols)} cols")
    out = ctypes.create_string_buffer(22 * n if n else 1)  # 22 bytes a pair suffice
    wrote = lb.mm_format_pairs(rows.ctypes.data_as(_u32p), cols.ctypes.data_as(_u32p),
                               n, out)
    return out.raw[:wrote]


def coo2csr(rows: np.ndarray, cols: np.ndarray, n_rows: int):
    """Stable COO->CSR (entries of a row keep input order, duplicates kept):
    uint32 ``(indptr, indices)``.  Raises ``ValueError`` on a row out of
    range.  Inputs of 2^20 entries or more, with at least a row a thread,
    take the blocked parallel grouping."""
    lb = lib()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    cols = np.ascontiguousarray(cols, dtype=np.uint32)
    nnz = len(rows)
    if len(cols) != nnz:
        raise ValueError(f"{nnz} rows but {len(cols)} cols")
    indptr = np.empty(n_rows + 1, dtype=np.uint32)
    indices = np.empty(nnz, dtype=np.uint32)
    args = (rows.ctypes.data_as(_u32p), cols.ctypes.data_as(_u32p), nnz, n_rows,
            indptr.ctypes.data_as(_u32p), indices.ctypes.data_as(_u32p))
    nt = threads()
    if nnz >= (1 << 20) and nt > 1 and n_rows >= nt:
        tmp_rows = np.empty(nnz, dtype=np.uint32)
        tmp_cols = np.empty(nnz, dtype=np.uint32)
        rc = lb.coo2csr_stable_par(*args, tmp_rows.ctypes.data_as(_u32p),
                                   tmp_cols.ctypes.data_as(_u32p), nt)
    else:
        rc = lb.coo2csr_stable(*args)
    if rc != 0:
        raise ValueError("row index out of range in COO->CSR")
    return indptr, indices


def _check_index(idx: np.ndarray, n: int, what: str) -> None:
    """The C loops index with ``idx`` unchecked: refuse an index outside
    ``[0, n)`` before a pointer goes in."""
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(
            f"{what} [{int(idx.min())}, {int(idx.max())}] out of range for {n}"
        )


def class_partition(indptr, indices, class_of_row, pos_in_class, n_classes: int):
    """Stable partition of a CSR's entries by the width class of the B row
    each one's column names (the native tier of
    ``ops/ell.py::_build_class_entries``): per class the ``(entry_rows,
    entry_pos)`` int32 arrays, in input order.  ``None`` without classes,
    past the int32 domain, or where the scratch memory was not had."""
    lb = lib()
    if n_classes == 0 or len(indices) > _INT32_MAX:  # uint32 indptr domain
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.uint32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    class_of_row = np.ascontiguousarray(class_of_row, dtype=np.int32)
    pos_in_class = np.ascontiguousarray(pos_in_class, dtype=np.int32)
    _check_index(indices, len(class_of_row), "column id")
    nnz = len(indices)
    out_rows = np.empty(nnz, np.int32)
    out_pos = np.empty(nnz, np.int32)
    cuts = np.empty(n_classes + 1, np.int64)
    kept = lb.ell_class_partition(
        indptr.ctypes.data_as(_u32p), len(indptr) - 1, indices.ctypes.data_as(_i32p),
        nnz, class_of_row.ctypes.data_as(_i32p), pos_in_class.ctypes.data_as(_i32p),
        n_classes, out_rows.ctypes.data_as(_i32p), out_pos.ctypes.data_as(_i32p),
        cuts.ctypes.data_as(_longp), threads(),
    )
    if kept < 0:
        return None
    rows_pc = [out_rows[cuts[c] : cuts[c + 1]] for c in range(n_classes)]
    pos_pc = [out_pos[cuts[c] : cuts[c + 1]] for c in range(n_classes)]
    return rows_pc, pos_pc


def row_weight(indptr, cols, weight):
    """``out[r]`` = the sum of ``weight[cols[e]]`` over row r's entries
    (int64; the native tier of ``ops/spgemm.py::row_flops``).  ``None``
    past the int32 domain."""
    lb = lib()
    if len(cols) > _INT32_MAX:  # uint32 indptr domain
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.uint32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    weight = np.ascontiguousarray(weight, dtype=np.int64)
    # the C loop reads weight[cols[e]] unchecked
    _check_index(cols, len(weight), "column id")
    n_rows = len(indptr) - 1
    out = np.empty(n_rows, np.int64)
    lb.csr_row_weight(indptr.ctypes.data_as(_u32p), n_rows, cols.ctypes.data_as(_i32p),
                      weight.ctypes.data_as(_i64p), out.ctypes.data_as(_i64p), threads())
    return out


def table_fill(indptr, indices, class_of_row, pos_in_class, tables, sentinel: int):
    """Fill the pre-allocated sliced-ELL class tables (``np.empty`` ``[rows_c,
    width_c]`` int32 each, written in place) in one parallel pass over B's
    rows, each row's tail padded with ``sentinel`` (the native tier of
    ``EllB.build``'s scatter).  ``True``, or ``None`` without tables or
    past the int32 domain."""
    lb = lib()
    if not tables or len(indices) > _INT32_MAX:  # uint32 indptr domain
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.uint32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    class_of_row = np.ascontiguousarray(class_of_row, dtype=np.int32)
    pos_in_class = np.ascontiguousarray(pos_in_class, dtype=np.int32)
    if len(class_of_row) != len(indptr) - 1 or len(pos_in_class) != len(class_of_row):
        raise ValueError("class_of_row / pos_in_class do not match the row count")
    for t in tables:
        if t.dtype != np.int32 or t.ndim != 2 or not t.flags.c_contiguous:
            raise ValueError("tables must be C-contiguous 2-D int32 arrays")
    ptrs = (ctypes.c_void_p * len(tables))(*[t.ctypes.data for t in tables])
    widths = np.array([t.shape[1] for t in tables], dtype=np.int64)
    lb.ell_table_fill(
        indptr.ctypes.data_as(_u32p), len(indptr) - 1, indices.ctypes.data_as(_i32p),
        class_of_row.ctypes.data_as(_i32p), pos_in_class.ctypes.data_as(_i32p), ptrs,
        widths.ctypes.data_as(_longp), sentinel, threads(),
    )
    return True


def _csr_args(indptr, indices, n_rows: int, n_cols: int, what: str):
    """``(ptr, idx)`` of a CSR operand as the C kernels take them (uint32
    pointers, int32 indices), its columns checked against ``n_cols``;
    ``None`` past the int32 domain."""
    if len(indices) > _INT32_MAX:  # uint32 indptr domain
        return None
    ptr = np.ascontiguousarray(indptr, dtype=np.uint32)
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    if len(ptr) != n_rows + 1:
        raise ValueError(f"{what} has {len(ptr) - 1} rows, not {n_rows}")
    _check_index(idx, n_cols, f"{what} column id")
    return ptr, idx


def _product_args(cap: int, operands):
    """The operands' C arguments, or ``None`` where one is past the int32
    domain or ``cap`` past the uint32 pointers."""
    if cap > _UINT32_MAX:
        return None
    out = []
    for operand in operands:
        arrays = _csr_args(*operand)
        if arrays is None:
            return None
        ptr, idx = arrays
        out += [ptr, idx]
    return out


def spgemm_host(a_indptr, a_indices, n_rows, n_cols, b_indptr, b_indices, cap: int):
    """Boolean Gustavson C = A·B on the host (the stamp-accumulator C
    kernel): ``(indptr uint32, indices int32, nnz)``.  Raises
    ``ValueError`` past ``cap`` output entries; ``None`` past the int32
    domain or without scratch memory."""
    lb = lib()
    k = len(b_indptr) - 1
    arrays = _product_args(cap, [(a_indptr, a_indices, n_rows, k, "A"),
                                 (b_indptr, b_indices, k, n_cols, "B")])
    if arrays is None:
        return None
    ap, ai, bp, bi = arrays
    c_ptr = np.empty(n_rows + 1, dtype=np.uint32)
    c_idx = np.empty(max(cap, 1), dtype=np.int32)
    out = lb.spgemm_host(
        ap.ctypes.data_as(_u32p), ai.ctypes.data_as(_i32p), n_rows, n_cols,
        bp.ctypes.data_as(_u32p), bi.ctypes.data_as(_i32p),
        c_ptr.ctypes.data_as(_u32p), c_idx.ctypes.data_as(_i32p), cap,
    )
    if out == -1:
        raise ValueError(f"host SpGEMM output exceeded cap={cap}")
    if out < 0:
        return None
    return c_ptr, c_idx[:out], int(out)


def masked_spgemm_host(f_indptr, f_indices, a_indptr, a_indices, n_rows, n_cols,
                       b_indptr, b_indices, cap: int):
    """C = F .* (A·B) on the host (one allow-stamp C kernel): ``(indptr
    uint32, indices int32, nnz)``; raises and returns ``None`` as
    :func:`spgemm_host`."""
    lb = lib()
    k = len(b_indptr) - 1
    arrays = _product_args(cap, [(f_indptr, f_indices, n_rows, n_cols, "F"),
                                 (a_indptr, a_indices, n_rows, k, "A"),
                                 (b_indptr, b_indices, k, n_cols, "B")])
    if arrays is None:
        return None
    fp, fi, ap, ai, bp, bi = arrays
    c_ptr = np.empty(n_rows + 1, dtype=np.uint32)
    c_idx = np.empty(max(cap, 1), dtype=np.int32)
    out = lb.masked_spgemm_host(
        fp.ctypes.data_as(_u32p), fi.ctypes.data_as(_i32p),
        ap.ctypes.data_as(_u32p), ai.ctypes.data_as(_i32p), n_rows, n_cols,
        bp.ctypes.data_as(_u32p), bi.ctypes.data_as(_i32p),
        c_ptr.ctypes.data_as(_u32p), c_idx.ctypes.data_as(_i32p), cap,
    )
    if out == -1:
        raise ValueError(f"host masked SpGEMM output exceeded cap={cap}")
    if out < 0:
        return None
    return c_ptr, c_idx[:out], int(out)


def spgemm_counts_host(a_indptr, a_indices, n_rows, n_cols, b_indptr, b_indices,
                       cap: int):
    """C = A·B on the host with each entry's multiplicity: ``(indptr
    uint32, indices int32, counts int64, nnz)``; raises and returns
    ``None`` as :func:`spgemm_host`."""
    lb = lib()
    k = len(b_indptr) - 1
    arrays = _product_args(cap, [(a_indptr, a_indices, n_rows, k, "A"),
                                 (b_indptr, b_indices, k, n_cols, "B")])
    if arrays is None:
        return None
    ap, ai, bp, bi = arrays
    c_ptr = np.empty(n_rows + 1, dtype=np.uint32)
    c_idx = np.empty(max(cap, 1), dtype=np.int32)
    c_cnt = np.empty(max(cap, 1), dtype=np.int64)
    out = lb.spgemm_counts_host(
        ap.ctypes.data_as(_u32p), ai.ctypes.data_as(_i32p), n_rows, n_cols,
        bp.ctypes.data_as(_u32p), bi.ctypes.data_as(_i32p),
        c_ptr.ctypes.data_as(_u32p), c_idx.ctypes.data_as(_i32p),
        c_cnt.ctypes.data_as(_i64p), cap,
    )
    if out == -1:
        raise ValueError(f"host counts SpGEMM output exceeded cap={cap}")
    if out < 0:
        return None
    return c_ptr, c_idx[:out], c_cnt[:out], int(out)
