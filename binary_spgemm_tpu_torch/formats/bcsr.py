"""Boolean CSR (pattern-only) matrix container.

Host-side numpy arrays: ``indptr: int32[n+1]`` (int64 once the entry count
passes the int32 domain), ``indices: int32[nnz]``, shape ``(n, m)``.  No value
array; the accumulation semiring is OR.  The arrays, the random generator and
the COO->CSR grouping are element-identical to ``binary_spgemm_tpu``'s, so both
packages build the same matrix from the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BCSR", "bcsr_from_arrays", "coo_to_csr_stable"]

INDEX_DTYPE = np.int32

# Row-pointer promotion threshold: an indptr whose total exceeds this is kept
# int64 (int32 column indices + int64 row pointers).  The device kernels work
# in the int32 domain (chunk-local pointers); only host row pointers widen.
INDPTR_INT32_MAX = int(np.iinfo(np.int32).max)


def coo_to_csr_stable(
    rows: np.ndarray, cols: np.ndarray, n_rows: int, n_cols: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Group COO entries by row with a *stable* (input-order-preserving)
    scatter: entries that share a row keep their input order and duplicates
    are not merged.  With ``n_cols`` the column indices are range-checked
    too (a column >= ``n_cols`` would collide with the kernels' sentinels).
    The grouping is the native host tier's write-cursor counting sort
    (:func:`..native.coo2csr`), and :func:`_coo_to_csr_numpy` past the
    int32 domain."""
    rows = np.asarray(rows, dtype=np.int64)
    raw_cols = np.asarray(cols)
    if len(raw_cols) and n_cols is not None:
        cmin, cmax = raw_cols.min(), raw_cols.max()
        if cmin < 0 or cmax >= n_cols:
            raise ValueError(
                f"column index out of range in COO->CSR: "
                f"[{cmin}, {cmax}] outside [0, {n_cols})"
            )
    cols = raw_cols.astype(INDEX_DTYPE, copy=False)
    if len(rows) and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("row index out of range in COO->CSR")
    if len(rows) > INDPTR_INT32_MAX:
        # the native grouping works in uint32 row pointers
        return _coo_to_csr_numpy(rows, cols, n_rows)
    from .. import native

    indptr, indices = native.coo2csr(rows, cols, n_rows)
    return indptr.astype(INDEX_DTYPE), indices.astype(INDEX_DTYPE)


def _coo_to_csr_numpy(rows: np.ndarray, cols: np.ndarray, n_rows: int):
    """The numpy branch of :func:`coo_to_csr_stable` (its native tier is
    :func:`..native.coo2csr`): a stable argsort by row; int64 row pointers
    past the int32 domain."""
    ptr_dtype = np.int64 if len(rows) > INDPTR_INT32_MAX else INDEX_DTYPE
    counts = np.bincount(rows, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(rows, kind="stable")
    indices = cols[order]
    return indptr.astype(ptr_dtype), indices.astype(INDEX_DTYPE)


@dataclasses.dataclass
class BCSR:
    """Host-side boolean CSR pattern matrix (no values; OR semiring)."""

    indptr: np.ndarray  # int32 [n_rows + 1] (int64 when nnz exceeds int32)
    indices: np.ndarray  # int32 [nnz]
    shape: tuple[int, int]

    def __post_init__(self):
        indptr = np.ascontiguousarray(self.indptr)
        total = int(indptr[-1]) if len(indptr) else 0
        ptr_dtype = np.int64 if total > INDPTR_INT32_MAX else INDEX_DTYPE
        self.indptr = indptr.astype(ptr_dtype, copy=False)
        self.indices = np.ascontiguousarray(self.indices, dtype=INDEX_DTYPE)
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        n = self.shape[0]
        if self.indptr.shape != (n + 1,):
            raise ValueError(
                f"indptr shape {self.indptr.shape} does not match n_rows={n}"
            )
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
            raise ValueError("indptr must start at 0 and end at nnz")

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i] : self.indptr[i + 1]]

    @classmethod
    def from_coo(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        shape: tuple[int, int],
        *,
        transpose: bool = False,
    ) -> "BCSR":
        """Build from COO pairs, preserving input order within each row.
        ``transpose=True`` groups by the second index (the CSR of the
        transpose of the input pairs)."""
        if transpose:
            rows, cols = cols, rows
            shape = (shape[1], shape[0])
        indptr, indices = coo_to_csr_stable(rows, cols, shape[0], shape[1])
        return cls(indptr, indices, shape)

    @classmethod
    def from_scipy(cls, mat) -> "BCSR":
        mat = mat.tocsr()
        return cls(
            np.asarray(mat.indptr),  # __post_init__ picks int32/int64
            mat.indices.astype(INDEX_DTYPE),
            tuple(mat.shape),
        )

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "BCSR":
        dense = np.asarray(dense) != 0
        rows, cols = np.nonzero(dense)
        return cls.from_coo(rows, cols, dense.shape)

    @classmethod
    def random(
        cls, n_rows: int, n_cols: int, nnz_per_row: float, *, seed: int = 0
    ) -> "BCSR":
        """Random Bernoulli pattern matrix ~ MATLAB ``sprand(n, m, d/m) > 0``:
        ~``nnz_per_row`` nonzeros per row, uniform positions, duplicates
        merged."""
        rng = np.random.default_rng(seed)
        total_cells = n_rows * n_cols
        density = min(nnz_per_row / n_cols, 1.0)
        # Poisson-approximate the pre-dedup draw count so the post-dedup
        # density matches sprand's
        k = int(rng.poisson(total_cells * density))
        if k == 0:
            return cls(
                np.zeros(n_rows + 1, INDEX_DTYPE),
                np.zeros(0, INDEX_DTYPE),
                (n_rows, n_cols),
            )
        lin = rng.integers(0, total_cells, size=k, dtype=np.uint64)
        lin = np.unique(lin)
        rows = (lin // np.uint64(n_cols)).astype(np.int64)
        cols = (lin % np.uint64(n_cols)).astype(np.int64)
        return cls.from_coo(rows, cols, (n_rows, n_cols))

    @classmethod
    def banded(
        cls,
        n: int,
        nnz_per_row: float,
        bandwidth: int,
        *,
        seed: int = 0,
        diagonal: bool = True,
    ) -> "BCSR":
        """Banded random pattern (a mesh-like, cage-class stand-in): the unit
        diagonal (when ``diagonal``) plus Poisson-drawn offsets within
        ``bandwidth`` of it, ~``nnz_per_row`` entries per row, deduplicated."""
        rng = np.random.default_rng(seed)
        extra = max(nnz_per_row - (1 if diagonal else 0), 0.0)
        counts = rng.poisson(extra, n)
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        off = rng.integers(-bandwidth, bandwidth + 1, len(rows))
        cols = np.clip(rows + off, 0, n - 1)
        if diagonal:
            diag = np.arange(n, dtype=np.int64)
            rows = np.concatenate([rows, diag])
            cols = np.concatenate([cols, diag])
        return cls.from_coo(rows, cols, (n, n)).sum_duplicates()

    @classmethod
    def random_blocked(
        cls,
        n: int,
        block: int = 128,
        blocks_per_row: float = 2.0,
        inner_density: float = 0.3,
        *,
        seed: int = 0,
    ) -> "BCSR":
        """Block-clustered random pattern: ~``blocks_per_row`` nonzero
        ``block x block`` tiles per block row, each filled Bernoulli
        ``inner_density`` — the input class of the blocked route
        (:func:`..ops.bsr.bsr_spgemm`)."""
        rng = np.random.default_rng(seed)
        nb = -(-n // block)
        k = int(blocks_per_row * nb)
        brows = rng.integers(0, nb, k)
        bcols = rng.integers(0, nb, k)
        keys = np.unique(brows.astype(np.int64) * nb + bcols)
        parts_r, parts_c = [], []
        for key in keys:
            br, bc = divmod(int(key), nb)
            h = min(block, n - br * block)
            w = min(block, n - bc * block)
            dense = rng.random((h, w)) < inner_density
            rr, cc = np.nonzero(dense)
            parts_r.append(rr + br * block)
            parts_c.append(cc + bc * block)
        if not parts_r:
            return cls(
                np.zeros(n + 1, INDEX_DTYPE), np.zeros(0, INDEX_DTYPE), (n, n)
            )
        return cls.from_coo(
            np.concatenate(parts_r), np.concatenate(parts_c), (n, n)
        )

    @classmethod
    def rmat(
        cls,
        scale: int,
        edge_factor: float = 16.0,
        *,
        a: float = 0.57,
        b: float = 0.19,
        c: float = 0.19,
        seed: int = 0,
        symmetric: bool = False,
    ) -> "BCSR":
        """R-MAT power-law graph pattern (Chakrabarti et al., SDM'04;
        Graph500 defaults a=0.57, b=c=0.19): ``2**scale`` vertices,
        ~``edge_factor`` edges per vertex, duplicates merged."""
        n = 1 << scale
        n_edges = int(edge_factor * n)
        rng = np.random.default_rng(seed)
        rows = np.zeros(n_edges, np.int64)
        cols = np.zeros(n_edges, np.int64)
        # per bit: quadrant probabilities (a, b, c, d), vectorised over edges
        for level in range(scale):
            u = rng.random(n_edges)
            right = u >= (a + b)  # row bit set (quadrants c, d)
            # P(col bit | row bit): b/(a+b) top, d/(c+d) bottom
            d = 1.0 - a - b - c
            p_col = np.where(right, d / max(c + d, 1e-12), b / max(a + b, 1e-12))
            down = rng.random(n_edges) < p_col
            rows |= right.astype(np.int64) << level
            cols |= down.astype(np.int64) << level
        if symmetric:
            rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        return cls.from_coo(rows, cols, (n, n)).sum_duplicates()

    @classmethod
    def from_torch(cls, t) -> "BCSR":
        """Build from a torch sparse tensor (CSR, COO or CSC layout) or a dense
        tensor, on any device (copied to the host first); nonzero values
        mark the pattern, so explicit zeros are dropped."""
        import torch

        if t.layout == torch.sparse_csr:
            vals = t.values().cpu().numpy()
            indptr = t.crow_indices().cpu().numpy()
            cols = t.col_indices().cpu().numpy()
            if np.all(vals != 0):
                return cls(indptr, cols, tuple(t.shape))
            rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
            keep = vals != 0
            return cls.from_coo(rows[keep], cols[keep], tuple(t.shape))
        if t.layout in (torch.sparse_coo, torch.sparse_csc):
            if t.layout == torch.sparse_csc:
                t = t.to_sparse_coo()
            t = t.coalesce()
            idx = t.indices().cpu().numpy()
            keep = t.values().cpu().numpy() != 0
            return cls.from_coo(idx[0][keep], idx[1][keep], tuple(t.shape))
        return cls.from_dense(t.cpu().numpy())

    def to_torch(self):
        """A host ``torch.sparse_csr_tensor`` with bool ones as values."""
        import torch

        return torch.sparse_csr_tensor(
            torch.from_numpy(np.ascontiguousarray(self.indptr)),
            torch.from_numpy(np.ascontiguousarray(self.indices)),
            torch.ones(self.nnz, dtype=torch.bool),
            size=self.shape,
        )

    def to_scipy(self):
        import scipy.sparse as sp

        data = np.ones(self.nnz, dtype=np.int64)
        return sp.csr_matrix((data, self.indices, self.indptr), shape=self.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=bool)
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr))
        out[rows, self.indices] = True
        return out

    def to_coo(self) -> tuple[np.ndarray, np.ndarray]:
        rows = np.repeat(
            np.arange(self.n_rows, dtype=np.int64), np.diff(self.indptr)
        )
        return rows, self.indices.astype(np.int64)

    def transpose(self) -> "BCSR":
        rows, cols = self.to_coo()
        return BCSR.from_coo(cols, rows, (self.n_cols, self.n_rows))

    def sort_indices(self) -> "BCSR":
        """A copy with ascending columns within every row (duplicates kept)."""
        rows, _ = self.to_coo()
        order = np.lexsort((self.indices, rows))
        return BCSR(self.indptr.copy(), self.indices[order], self.shape)

    def is_canonical(self) -> bool:
        """True when every row's columns are strictly ascending (sorted and
        deduplicated) — the form every op here emits."""
        if self.nnz <= 1:
            return True
        rows, cols = self.to_coo()
        keys = rows * np.int64(self.n_cols) + cols
        return bool(np.all(np.diff(keys) > 0))

    def sum_duplicates(self) -> "BCSR":
        """A canonical form: sorted per row and deduplicated (``self`` when
        already canonical — BCSR arrays are treated as immutable)."""
        if self.is_canonical():
            return self
        rows, cols = self.to_coo()
        keys = rows * np.int64(self.n_cols) + cols
        keys = np.unique(keys)
        rows = keys // self.n_cols
        cols = keys % self.n_cols
        return BCSR.from_coo(rows, cols, self.shape)

    def equals(self, other: "BCSR") -> bool:
        return (
            self.shape == tuple(other.shape)
            and np.array_equal(self.indptr, other.indptr)
            and np.array_equal(self.indices, other.indices)
        )

    def diff(self, other: "BCSR", *, max_rows: int = 10) -> str:
        """Where two matrices diverge, row by row: ``""`` when equal, else a
        report naming the first ``max_rows`` differing rows with (up to 16
        of) their columns."""
        if self.equals(other):
            return ""
        if self.shape != tuple(other.shape):
            return f"shape mismatch: {self.shape} vs {tuple(other.shape)}"
        lines = []
        if self.nnz != other.nnz:
            lines.append(f"nnz mismatch: {self.nnz} vs {other.nnz}")
        a_len = np.diff(self.indptr)
        b_len = np.diff(other.indptr)
        # rows differing in length first, then rows of equal length whose
        # columns differ
        bad_rows = list(np.flatnonzero(a_len != b_len)[:max_rows])
        if len(bad_rows) < max_rows:
            for i in np.flatnonzero(a_len == b_len):
                s0, s1 = int(self.indptr[i]), int(self.indptr[i + 1])
                o0 = int(other.indptr[i])
                if not np.array_equal(self.indices[s0:s1],
                                      other.indices[o0 : o0 + (s1 - s0)]):
                    bad_rows.append(int(i))
                    if len(bad_rows) >= max_rows:
                        break
        bad_rows.sort()
        n_bad = int((a_len != b_len).sum())
        lines.append(f"{max(n_bad, len(bad_rows))}+ differing rows; first "
                     f"{len(bad_rows)}:")
        for i in bad_rows[:max_rows]:
            i = int(i)
            lines.append(f"  row {i}: self({a_len[i]}) {self.row(i)[:16].tolist()}"
                         f" vs other({b_len[i]}) {other.row(i)[:16].tolist()}")
        return "\n".join(lines)

    def flops(self, other: "BCSR") -> int:
        """Gustavson flop count of self @ other: the sum over the entries
        (i, j) of self of nnz(other row j)."""
        blen = np.diff(other.indptr).astype(np.int64)
        return int(blen[self.indices].sum())

    def __repr__(self):
        return f"BCSR(shape={self.shape}, nnz={self.nnz})"


def bcsr_from_arrays(indptr, indices, shape) -> BCSR:
    """A :class:`BCSR` from plain arrays (e.g. another package's matrix,
    handed over as numpy ``indptr``/``indices`` and its shape).  The arrays
    are copied, so the result shares no memory with the caller's."""
    return BCSR(
        np.array(indptr, copy=True), np.array(indices, copy=True), tuple(shape)
    )
