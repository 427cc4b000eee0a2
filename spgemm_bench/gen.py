"""The benchmark's own input generators, in numpy, from ``--seed``.

These are the yardstick's copies: a later change to the program's own
generators must not move the inputs a cell measures.  A configuration's
``structure_seed`` draws its matrix, and ``--seed`` relabels its vertices
(:func:`relabel`) within classes that keep every row's length and flops,
so that the program plans the same work for every seed while the answers
differ; a configuration whose plan still moves with the labels says
``"relabel": false`` and is the same matrix for every seed.  The result is
a canonical CSR pattern ``(indptr int64 [n+1], indices int32 [nnz], n)``:
square, columns strictly ascending within every row.

* ``sprand``: MATLAB's ``sprand(n, n, d/n) > 0`` (the reference's
  ``Matlab/write_spm.m``): a Poisson count of uniform draws over the n x n
  cells, duplicates merged.
* ``kronecker``: the Graph500 Kronecker (R-MAT) generator: ``edge_factor *
  2**scale`` edges, each placed by ``scale`` independent quadrant choices
  with probabilities ``(a, b, c, 1 - a - b - c)``; the vertex labels are
  then permuted at random (the specification's scramble).  ``symmetric``
  adds every edge's reverse and ``self_loops: false`` drops the diagonal,
  the input form of GraphChallenge's static triangle counting.
"""
from __future__ import annotations

import numpy as np

__all__ = ["GENERATORS", "flops", "generate", "rng_for"]


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator for ``seed`` (any whole number, negative or past 64
    bits folded into range) and a sub-stream, so that the inputs and the
    harness's own draws never share a stream."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def _sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique`` by a sort and a neighbour test (numpy 2.3's
    ``np.unique`` took 84 s on 25 M int64 keys where the sort takes 2 s)."""
    keys = np.sort(keys)
    keep = np.ones(len(keys), bool)
    np.not_equal(keys[1:], keys[:-1], out=keep[1:])
    return keys[keep]


def _csr_from_keys(keys: np.ndarray, n: int):
    """Canonical CSR from sorted, unique ``row * n + col`` keys (int64)."""
    rows = keys // n
    indices = (keys - rows * n).astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, indices


def sprand(cfg: dict, rng: np.random.Generator):
    n, d = int(cfg["n"]), float(cfg["d"])
    cells = n * n
    k = int(rng.poisson(cells * min(d / n, 1.0)))
    keys = _sorted_unique(rng.integers(0, cells, size=k, dtype=np.int64))
    return (*_csr_from_keys(keys, n), n)


def kronecker(cfg: dict, rng: np.random.Generator):
    scale = int(cfg["scale"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    n = 1 << scale
    m = int(cfg["edge_factor"]) * n
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    ab, c_norm, a_norm = a + b, c / (1.0 - a - b), a / (a + b)
    for level in range(scale):
        # the Graph500 reference's quadrant draw: the row bit with
        # probability c + d, then the column bit given the row bit
        row_bit = rng.random(m) > ab
        col_bit = rng.random(m) > np.where(row_bit, c_norm, a_norm)
        rows |= row_bit.astype(np.int64) << level
        cols |= col_bit.astype(np.int64) << level
    perm = rng.permutation(n).astype(np.int64)
    rows, cols = perm[rows], perm[cols]
    if cfg.get("symmetric", False):
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    if not cfg.get("self_loops", True):
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    keys = _sorted_unique(rows * n + cols)
    return (*_csr_from_keys(keys, n), n)


GENERATORS = {"sprand": sprand, "kronecker": kronecker}


def _width_class(lens: np.ndarray) -> np.ndarray:
    """Eighth-octave classes of row lengths: exact up to 8, then 8 classes an
    octave (the widths a sliced-ELL plan pads a row to)."""
    p = np.left_shift(1, np.frexp(np.maximum(lens, 1).astype(np.float64) * 2 - 1)[1] - 1)
    step = np.maximum(p // 8, 1)
    return (lens + step - 1) // step * step


def _row_sums(values: np.ndarray, indptr: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-row sums of per-entry ``values`` (0 for an empty row)."""
    out = np.zeros(len(lens), values.dtype)
    live = lens > 0
    if live.any():
        out[live] = np.add.reduceat(values, indptr[:-1][live])
    return out


def relabel(indptr: np.ndarray, indices: np.ndarray, n: int, rng: np.random.Generator):
    """``P A P^T`` for a permutation ``P`` drawn at random within classes of
    vertices that agree in their row length, their row's flops in A·A and
    the multiset of their neighbours' width classes: every row keeps the
    sizes a planner reads, so every seed gives the program the same work,
    in another order."""
    lens = np.diff(indptr)
    rf = _row_sums(lens[indices].astype(np.int64), indptr, lens)
    # the class key: a hash of (length, flops, the multiset of the
    # neighbours' width classes), fixed random words summed mod 2^64
    wc = _width_class(lens)
    words = np.random.default_rng(0).integers(0, 1 << 63, size=3 + int(wc.max(initial=0)),
                                              dtype=np.int64).astype(np.uint64)
    key = _row_sums(words[2 + wc[indices]], indptr, lens)
    key += lens.astype(np.uint64) * words[0] + rf.astype(np.uint64) * words[1]
    by_id = np.argsort(key, kind="stable")
    draw = rng.permutation(n)
    by_draw = draw[np.argsort(key[draw], kind="stable")]
    perm = np.empty(n, np.int64)
    perm[by_id] = by_draw
    keys = np.repeat(perm * n, lens)
    keys += perm[indices]
    keys.sort()
    return (*_csr_from_keys(keys, n), n)


def generate(cfg: dict, seed: int):
    """``(indptr, indices, n)`` of the configuration's matrix for ``seed``:
    the matrix its ``structure_seed`` draws, relabeled by ``seed`` unless the
    configuration says ``"relabel": false`` (then every seed gets the matrix
    itself)."""
    kind = cfg["generator"]
    if kind not in GENERATORS:
        raise ValueError(f"unknown generator {kind!r} (have {sorted(GENERATORS)})")
    indptr, indices, n = GENERATORS[kind](cfg, rng_for(cfg["structure_seed"]))
    if not cfg.get("relabel", True):
        return indptr, indices, n
    return relabel(indptr, indices, n, rng_for(seed))


def flops(indptr: np.ndarray, indices: np.ndarray) -> int:
    """Gustavson flops of A·A: the sum over A's entries (i, k) of nnz(A[k, :])."""
    lens = np.diff(indptr)
    return int(lens[indices].sum(dtype=np.int64))
