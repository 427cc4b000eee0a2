"""Host (CPU) engine for the small-flop regime.

Counterpart of ``binary_spgemm_tpu/ops/host.py``.  A product whose
Gustavson flop count is tiny (the reference's own validity fixture, n =
50000 with 25,000 nnz, is the canonical one) costs less on the host than one
round trip to the card, so :func:`..spgemm.spgemm` diverts products of at
most :data:`HOST_MAX_FLOPS` flops here, as the JAX package's router does,
and the masked, union and fused-OR families divert their small products
here the same way (:data:`HOST_OR_MAX_NNZ` for the last two), and so does
``spgemm_counts`` (:func:`host_spgemm_counts`).

Two tiers, as in the JAX package:

* the native C kernels (:func:`..native.spgemm_host`,
  ``masked_spgemm_host``, ``spgemm_counts_host``): Gustavson with a *stamp*
  sparse accumulator (a per-row tag instead of a bool array and its reset
  walk) and a per-row insertion sort or qsort;
* the numpy branches (``_spgemm_numpy``, ``_masked_spgemm_numpy``,
  ``_spgemm_counts_numpy``): a vectorised expand–sort–compress
  (grouped-arange expansion, then ``np.unique`` over int64 ``row * m +
  col`` keys), taken past the native kernels' int32 domain.

Both give the device engines' output contract: exclusive row pointers,
ascending deduplicated columns in each row, bit-exact with scipy.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..formats.bcsr import BCSR

__all__ = [
    "HOST_MAX_FLOPS",
    "HOST_OR_MAX_NNZ",
    "host_masked_spgemm",
    "host_spgemm",
    "host_spgemm_counts",
    "host_spgemm_or",
    "host_spm_or",
]

# Router threshold (verbatim): products of at most this many flops run here.
HOST_MAX_FLOPS = 2_000_000

# Union router threshold on the operands' combined nnz (verbatim).
HOST_OR_MAX_NNZ = 1 << 18


def _expand_numpy(a: BCSR, b: BCSR) -> tuple[np.ndarray, np.ndarray]:
    """All (row, col) products of the Gustavson expansion, duplicates kept."""
    alen = np.diff(a.indptr).astype(np.int64)
    a_rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), alen)
    blen = np.diff(b.indptr).astype(np.int64)[a.indices]
    starts = b.indptr[a.indices].astype(np.int64)
    total = int(blen.sum())
    rows = np.repeat(a_rows, blen)
    # grouped arange: flat[k] walks each B row segment start..start+len
    seg_start = np.cumsum(blen) - blen
    offset = np.arange(total, dtype=np.int64) - np.repeat(seg_start, blen)
    flat = np.repeat(starts, blen) + offset
    cols = b.indices[flat].astype(np.int64)
    return rows, cols


def _keys_to_csr(keys: np.ndarray, n: int, m: int) -> BCSR:
    """CSR of sorted unique ``row * m + col`` keys."""
    rows = keys // m
    cols = (keys % m).astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return BCSR(indptr, cols, (n, m))


def host_spgemm(a: BCSR, b: BCSR) -> BCSR:
    """C = A·B on the host.  Callers keep the flop count inside the int64
    key domain (the router bounds it far below)."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    n, m = a.n_rows, b.n_cols
    res = native.spgemm_host(a.indptr, a.indices, n, m, b.indptr, b.indices, a.flops(b))
    if res is None:
        return _spgemm_numpy(a, b)
    c_ptr, c_idx, _ = res
    return BCSR(c_ptr.astype(np.int64), c_idx, (n, m))


def _spgemm_numpy(a: BCSR, b: BCSR) -> BCSR:
    """The numpy branch of :func:`host_spgemm`."""
    n, m = a.n_rows, b.n_cols
    rows, cols = _expand_numpy(a, b)
    keys = np.unique(rows * np.int64(m) + cols)
    return _keys_to_csr(keys, n, m)


def host_spgemm_counts(a: BCSR, b: BCSR) -> tuple[BCSR, np.ndarray]:
    """C = A·B on the host with each entry's multiplicity (int64), the
    integer product of the 0/1 operands; the operands must be canonical
    (duplicate entries would inflate the counts)."""
    n, m = a.n_rows, b.n_cols
    res = native.spgemm_counts_host(a.indptr, a.indices, n, m, b.indptr, b.indices,
                                    a.flops(b))
    if res is None:
        return _spgemm_counts_numpy(a, b)
    c_ptr, c_idx, c_cnt, _ = res
    return BCSR(c_ptr.astype(np.int64), c_idx, (n, m)), c_cnt


def _spgemm_counts_numpy(a: BCSR, b: BCSR) -> tuple[BCSR, np.ndarray]:
    """The numpy branch of :func:`host_spgemm_counts`."""
    n, m = a.n_rows, b.n_cols
    rows, cols = _expand_numpy(a, b)
    keys, counts = np.unique(rows * np.int64(m) + cols, return_counts=True)
    return _keys_to_csr(keys, n, m), counts.astype(np.int64)


def host_spm_or(a: BCSR, b: BCSR) -> BCSR:
    """C = A OR B on the host: one ``np.unique`` over both operands' packed
    ``row * m + col`` keys."""
    n, m = a.shape
    ra, ca = a.to_coo()
    rb, cb = b.to_coo()
    keys = np.unique(np.concatenate([ra * np.int64(m) + ca, rb * np.int64(m) + cb]))
    return _keys_to_csr(keys, n, m)


def host_masked_spgemm(f: BCSR, a: BCSR, b: BCSR) -> BCSR:
    """C = F .* (A·B) on the host (mask first; ``f`` canonical)."""
    n, m = a.n_rows, b.n_cols
    res = native.masked_spgemm_host(f.indptr, f.indices, a.indptr, a.indices, n, m,
                                    b.indptr, b.indices, min(a.flops(b), f.nnz))
    if res is None:
        return _masked_spgemm_numpy(f, a, b)
    c_ptr, c_idx, _ = res
    return BCSR(c_ptr.astype(np.int64), c_idx, (n, m))


def _masked_spgemm_numpy(f: BCSR, a: BCSR, b: BCSR) -> BCSR:
    """The numpy branch of :func:`host_masked_spgemm`."""
    n, m = a.n_rows, b.n_cols
    rows, cols = _expand_numpy(a, b)
    keys = np.unique(rows * np.int64(m) + cols)
    f_rows, f_cols = f.to_coo()
    keys = np.intersect1d(keys, f_rows * np.int64(m) + f_cols, assume_unique=True)
    return _keys_to_csr(keys, n, m)


def host_spgemm_or(d: BCSR, a: BCSR, b: BCSR, mask: BCSR | None = None) -> BCSR:
    """C = D OR ((mask .*)? (A·B)) on the host, from the host product and the
    key union.  D is unconditional (``D ∪ (F ∩ A·B)``), as on the device
    engines (see :mod:`.fused`)."""
    c = host_spgemm(a, b) if mask is None else host_masked_spgemm(mask, a, b)
    return host_spm_or(d, c)
