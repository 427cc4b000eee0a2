"""The port's Matrix-Market ingest and egest against the JAX package's, on
the CPU: the same arrays from the repository's validity fixture in both
index orders, the row-range slice, gzip, symmetric expansion, the header
errors, and round trips through ``write_pattern`` and ``write_integer``."""
import gzip
import os

import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.io import mmio as jx_mmio

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.io import mmio as tp_mmio

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "validity_test.mtx")


def same(j, t):
    return (tuple(j.shape) == tuple(t.shape) and j.indptr.dtype == t.indptr.dtype
            and np.array_equal(j.indptr, t.indptr) and np.array_equal(j.indices, t.indices))


def write(tmp_path, text, name="m.mtx"):
    p = tmp_path / name
    p.write_text(text)
    return p


@pytest.mark.parametrize("transpose", [True, False])
def test_fixture_matches_jax(transpose):
    j = jx.read_pattern(FIXTURE, transpose=transpose)
    t = tp.read_pattern(FIXTURE, transpose=transpose)
    assert same(j, t) and t.shape == (50000, 50000) and t.nnz == 25148
    # transpose semantics: the file's second index is the row
    assert t.equals(tp.read_pattern(FIXTURE, transpose=not transpose).transpose())


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("lo,hi", [(0, 50000), (1000, 2600), (49990, 50000), (7, 7)])
def test_row_range_matches_jax(transpose, lo, hi):
    j = jx.read_pattern(FIXTURE, transpose=transpose, row_range=(lo, hi))
    t = tp.read_pattern(FIXTURE, transpose=transpose, row_range=(lo, hi))
    assert same(j, t) and t.n_rows == hi - lo
    full = tp.read_pattern(FIXTURE, transpose=transpose)
    assert np.array_equal(t.indices, full.indices[full.indptr[lo] : full.indptr[hi]])


def test_gzip_and_value_columns(tmp_path):
    text = ("%%MatrixMarket matrix coordinate real general\n% a comment\n\n"
            "4 3 5\n1 1 3.5\n2 3 -1.0\n4 2 0.25\n1 1 2\n3 1 7\n")
    plain = write(tmp_path, text)
    gz = tmp_path / "m.mtx.gz"
    with gzip.open(gz, "wt") as f:
        f.write(text)
    for transpose in (True, False):
        t = tp.read_pattern(plain, transpose=transpose)
        assert same(jx.read_pattern(plain, transpose=transpose), t)
        assert t.equals(tp.read_pattern(gz, transpose=transpose))
    t = tp.read_pattern(plain, transpose=False)
    assert t.nnz == 5 and t.indices.tolist() == [0, 0, 2, 0, 1]  # file order, duplicates


def test_symmetric_expansion(tmp_path):
    p = write(tmp_path, "%%MatrixMarket matrix coordinate pattern symmetric\n"
                        "3 3 3\n2 1\n3 3\n3 2\n")
    for expand in (False, True):
        j = jx.read_pattern(p, transpose=False, expand_symmetric=expand)
        t = tp.read_pattern(p, transpose=False, expand_symmetric=expand)
        assert same(j, t) and t.nnz == (5 if expand else 3)
    with pytest.raises(ValueError, match="row_range with expand_symmetric"):
        tp.read_pattern(p, expand_symmetric=True, row_range=(0, 1))


def test_header_errors(tmp_path):
    b = tp_mmio.read_banner("%%MatrixMarket matrix coordinate pattern general\n")
    jb = jx_mmio.read_banner("%%MatrixMarket matrix coordinate pattern general\n")
    assert (b.object, b.format, b.field, b.symmetry) == (
        jb.object, jb.format, jb.field, jb.symmetry)
    assert repr(b) == repr(jb)
    with pytest.raises(ValueError, match="not a MatrixMarket banner"):
        tp_mmio.read_banner("%%NotMM x y z w")
    for text, match in (
            ("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n", "coordinate"),
            ("%%MatrixMarket matrix coordinate pattern general\n% only comments\n",
             "missing size line"),
            ("%%MatrixMarket matrix coordinate pattern general\n3 3 3\n1 1\n2 2\n",
             "expected 3 entries"),
            # the native parser (the JAX package's too) finds the truncated
            # entry; the numpy branch finds a token count not divisible by
            # the fields
            ("%%MatrixMarket matrix coordinate real general\n3 3 2\n1 1 1\n2 2\n",
             "malformed Matrix-Market entry body")):
        p = write(tmp_path, text)
        with pytest.raises(ValueError, match=match):
            tp.read_pattern(p)
        with pytest.raises(ValueError, match=match):
            jx.read_pattern(p)
    with pytest.raises(ValueError, match="not divisible"):
        tp_mmio._parse_numpy(b"1 1 1\n2 2\n", 2, 3)
    empty = write(tmp_path, "%%MatrixMarket matrix coordinate pattern general\n4 5 0\n")
    assert same(jx.read_pattern(empty), tp.read_pattern(empty))


@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
def test_write_pattern_round_trip(tmp_path, suffix):
    t = tp.BCSR.random(60, 45, 2.5, seed=11)
    j = jx.BCSR(t.indptr, t.indices, t.shape)
    tp.write_pattern(tmp_path / ("t" + suffix), t, comment="two\nlines")
    jx.write_pattern(tmp_path / ("j" + suffix), j, comment="two\nlines")
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(tmp_path / ("t" + suffix), "rb") as ft, opener(tmp_path / ("j" + suffix), "rb") as fj:
        assert ft.read() == fj.read()
    back = tp.read_pattern(tmp_path / ("t" + suffix), transpose=False)
    assert back.equals(t)
    assert tp.read_pattern(tmp_path / ("t" + suffix)).equals(t.transpose())


@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
def test_write_integer_round_trip(tmp_path, suffix):
    a = tp.BCSR.random(80, 70, 4.0, seed=3)
    b = tp.BCSR.random(70, 90, 4.0, seed=4)
    c, counts = tp.spgemm_counts(a, b, device="cpu")
    tp.write_integer(tmp_path / ("t" + suffix), c, counts, comment="A·B")
    jx.write_integer(tmp_path / ("j" + suffix), jx.BCSR(c.indptr, c.indices, c.shape), counts,
                     comment="A·B")
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(tmp_path / ("t" + suffix), "rb") as ft, opener(tmp_path / ("j" + suffix), "rb") as fj:
        body = ft.read()
        assert body == fj.read()
    assert body.startswith(b"%%MatrixMarket matrix coordinate integer general\n% A")
    # the values read back as the third column; the support as a pattern
    data = np.loadtxt(gzip.open(tmp_path / ("t" + suffix)) if suffix.endswith(".gz")
                      else tmp_path / ("t" + suffix), comments="%", dtype=np.int64)
    assert data[0].tolist() == [80, 90, c.nnz]  # the size line
    assert np.array_equal(data[1:, 2], counts)
    assert tp.read_pattern(tmp_path / ("t" + suffix), transpose=False).equals(c)
    with pytest.raises(ValueError, match="values shape"):
        tp.write_integer(tmp_path / "x.mtx", c, counts[1:])
    with pytest.raises(ValueError, match="integer values"):
        tp.write_integer(tmp_path / "x.mtx", c, counts.astype(np.float64))
