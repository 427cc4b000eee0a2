"""The port's native host tier (``binary_spgemm_tpu_torch/native``) on the CPU.

Each helper's arrays equal, element for element and dtype for dtype, its
numpy branch in the port and the JAX package's native helper on the same
seeded inputs (where the JAX package's library builds); the malformed and
out-of-range cases of ``tests/test_native.py`` raise as they do there; the
parallel tiers equal the serial ones; a build without a compiler, or one the
compiler refuses, raises; processes that build at once all load a whole
library; and every caller the tier is wired into gives results identical to
the JAX package's, also where a size guard sends it to its numpy branch.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu import native as jx_native
from binary_spgemm_tpu.ops import ell as jx_ell
from binary_spgemm_tpu.ops import host as jx_host
from binary_spgemm_tpu.ops import spgemm as jx_sp

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch import native
from binary_spgemm_tpu_torch.formats import bcsr as tp_bcsr
from binary_spgemm_tpu_torch.io import mmio
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import host
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.parallel.launch import launch

import _torch_dist_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def same(x, y) -> bool:
    """Equal arrays of one dtype (or equal nests of them)."""
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(same(p, q) for p, q in zip(x, y))
    if isinstance(x, np.ndarray):
        return x.dtype == y.dtype and np.array_equal(x, y)
    return x == y


def same_csr(j, t) -> bool:
    return (np.array_equal(j.indptr, t.indptr) and np.array_equal(j.indices, t.indices)
            and j.indptr.dtype == t.indptr.dtype and tuple(j.shape) == tuple(t.shape))


def jax_native():
    """The JAX package's native library, or a skip where it does not build."""
    if jx_native.lib() is None:
        pytest.skip("the JAX package's native library does not build here")
    return jx_native


# -- the build -----------------------------------------------------------------


def test_library_is_built_under_a_hash_of_source_and_flags(monkeypatch):
    lib = native.lib()
    path = native._target()
    assert path.exists() and path.parent == native.BUILD
    assert re.fullmatch(r"libmmparse-[0-9a-f]{12}\.so", path.name)
    assert lib._name == str(path)
    monkeypatch.setattr(native, "CFLAGS", native.CFLAGS + ["-g"])
    assert native._target() != path


def test_a_build_without_a_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path)
    monkeypatch.setattr(native, "COMPILERS", ("no-such-compiler-for-mmparse",))
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.lib()
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.format_pairs(np.zeros(1), np.zeros(1))
    assert list(tmp_path.iterdir()) == []


def test_a_refused_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path)
    monkeypatch.setattr(native, "CFLAGS", native.CFLAGS + ["-fno-such-option-mmparse"])
    with pytest.raises(RuntimeError, match="no-such-option-mmparse"):
        native.lib()
    assert list(tmp_path.iterdir()) == []  # no library and no temporary file


BUILD_AND_USE = """
import importlib.util, sys
from pathlib import Path
spec = importlib.util.spec_from_file_location("mmnative", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.BUILD = Path(sys.argv[2])
sys.stdout.write(mod.format_pairs([0, 2], [1, 9]).decode())
"""


def test_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Four processes build into one empty directory at once: each compiles
    into its own file and moves it into place, so every one loads a whole
    library, and one library is left, with no temporary file."""
    src = os.path.join(ROOT, "binary_spgemm_tpu_torch", "native", "__init__.py")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_USE, src, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out == "1 2\n3 10\n"
    assert [f.name for f in tmp_path.iterdir()] == [native._target().name]


def test_threads_divide_the_cores_among_local_ranks(monkeypatch):
    cores = os.cpu_count() or 1
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert native.threads() == cores
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert native.threads() == max(cores // 2, 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(4 * cores))
    assert native.threads() == 1


def test_launched_ranks_see_their_local_rank_count():
    for facts in launch(_torch_dist_cases.native_threads, 2, device="cpu", timeout=300):
        assert facts == ("2", max((os.cpu_count() or 1) // 2, 1))


# -- the Matrix-Market body ----------------------------------------------------


def pairs_body(rng, n, fields=2, hi=4000):
    rows = rng.integers(1, hi, n)
    cols = rng.integers(1, hi, n)
    if fields == 2:
        text = "".join(f"{r} {c}\n" for r, c in zip(rows, cols))
    else:
        vals = rng.random(n)
        text = "".join(f"{r}\t{c}  {v:.6e}\r\n" for r, c, v in zip(rows, cols, vals))
    return text.encode(), rows, cols


@pytest.mark.parametrize("n, fields", [(7, 2), (5000, 3), (120_000, 3)])
def test_parse_pairs_equals_numpy_and_jax(n, fields):
    rng = np.random.default_rng(n)
    body, rows, cols = pairs_body(rng, n, fields)
    got = native.parse_pairs(body, n, fields)
    assert got[0].dtype == np.uint32 and np.array_equal(got[0], rows)
    assert np.array_equal(got[1], cols)
    r, c = mmio._parse_numpy(body, n, fields)
    assert np.array_equal(got[0], r) and np.array_equal(got[1], c)
    assert same(got, jax_native().parse_pairs(body, n, fields))
    # a buffer (the mmap path's memoryview) parses as the bytes do
    assert same(got, native.parse_pairs(memoryview(body), n, fields))


def test_parallel_parse_and_convert_equal_the_serial_ones():
    """Past 1 MiB the OpenMP parse, past 2^20 entries the blocked parallel
    COO->CSR: both equal to the serial C functions, stability included."""
    rng = np.random.default_rng(3)
    n = (1 << 20) + 4099
    rows = rng.integers(0, 4000, n, dtype=np.uint32)
    cols = rng.integers(0, 4000, n, dtype=np.uint32)
    body = native.format_pairs(rows, cols)
    assert len(body) > (1 << 20)
    pr, pc = native.parse_pairs(body, n, 2)
    assert np.array_equal(pr - 1, rows) and np.array_equal(pc - 1, cols)
    lib = native.lib()
    u32p = ctypes.POINTER(ctypes.c_uint32)
    sr, sc = np.empty(n, np.uint32), np.empty(n, np.uint32)
    assert lib.mm_parse_pairs(body, len(body), n, 2, sr.ctypes.data_as(u32p),
                              sc.ctypes.data_as(u32p)) == n
    assert np.array_equal(sr, pr) and np.array_equal(sc, pc)
    ip, ix = native.coo2csr(rows, cols, 4000)
    ip_s, ix_s = np.empty(4001, np.uint32), np.empty(n, np.uint32)
    assert lib.coo2csr_stable(rows.ctypes.data_as(u32p), cols.ctypes.data_as(u32p), n,
                              4000, ip_s.ctypes.data_as(u32p),
                              ix_s.ctypes.data_as(u32p)) == 0
    assert np.array_equal(ip, ip_s) and np.array_equal(ix, ix_s)
    ref_ptr, ref_idx = tp_bcsr._coo_to_csr_numpy(rows.astype(np.int64),
                                                 cols.astype(np.int32), 4000)
    assert np.array_equal(ip, ref_ptr) and np.array_equal(ix.astype(np.int32), ref_idx)


def test_parse_pairs_malformed_and_truncated():
    for body, nnz, fields in ((b"1 x\n", 1, 2), (b"1 2 3\n4\n", 2, 3),
                              (b"1 4294967296\n", 1, 2), (b"-1 2\n", 1, 2)):
        with pytest.raises(ValueError, match="malformed"):
            native.parse_pairs(body, nnz, fields)
    with pytest.raises(ValueError, match="expected 5 entries, found 1"):
        native.parse_pairs(b"1 2\n", 5, 2)
    rows, cols = native.parse_pairs(b"4294967295 1\n", 1, 2)
    assert int(rows[0]) == 4294967295 and rows.dtype == np.uint32


@pytest.mark.parametrize("which", [0, 1])
def test_parse_pairs_filtered_equals_parse_then_filter(which):
    rng = np.random.default_rng(which)
    body, rows, cols = pairs_body(rng, 3000, 3, hi=100)
    lo, hi = 20, 61
    got = native.parse_pairs_filtered(body, 3000, 3, which, lo, hi)
    r, c = mmio._parse_numpy(body, 3000, 3)
    keep = ((c if which else r) >= lo) & ((c if which else r) < hi)
    assert np.array_equal(got[0], r[keep]) and np.array_equal(got[1], c[keep])
    assert got[0].dtype == np.uint32
    assert same(got, jax_native().parse_pairs_filtered(body, 3000, 3, which, lo, hi))
    with pytest.raises(ValueError, match="malformed"):
        native.parse_pairs_filtered(b"1 x\n", 1, 2, which, 0, 9)


def test_format_pairs_equals_numpy_and_jax():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 31, 1000)
    cols = rng.integers(0, 1 << 31, 1000)
    rows[:2], cols[:2] = 0, (1 << 32) - 2
    got = native.format_pairs(rows, cols)
    assert got == mmio._format_pairs_numpy(rows, cols)
    assert got == jax_native().format_pairs(rows, cols)
    assert native.format_pairs(np.zeros(0), np.zeros(0)) == b""
    assert native.format_pairs(np.array([0, 2]), np.array([1, 9])) == b"1 2\n3 10\n"


# -- COO -> CSR ----------------------------------------------------------------


def test_coo2csr_equals_numpy_and_jax():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 50, 500)
    cols = rng.integers(0, 60, 500)
    got = native.coo2csr(rows, cols, 50)
    ref_ptr, ref_idx = tp_bcsr._coo_to_csr_numpy(rows, cols.astype(np.int32), 50)
    assert np.array_equal(got[0], ref_ptr) and np.array_equal(got[1], ref_idx)
    assert got[0].dtype == got[1].dtype == np.uint32
    assert same(got, jax_native().coo2csr(rows, cols, 50))
    # stability: the entries of a row keep their input order
    p2, i2 = native.coo2csr(np.zeros(10, np.int64), np.arange(10)[::-1].copy(), 3)
    assert i2.tolist() == list(range(9, -1, -1)) and p2.tolist() == [0, 10, 10, 10]
    with pytest.raises(ValueError, match="row index out of range"):
        native.coo2csr(np.array([5]), np.array([0]), 3)


# -- the sliced-ELL plan -------------------------------------------------------


CASES = [("random", 900, 3.0, 1), ("rmat", 11, 6.0, 2), ("random", 64, 0.4, 3)]


def case(kind, n, d, seed):
    if kind == "rmat":
        return jx.BCSR.rmat(n, d, seed=seed)
    return jx.BCSR.random(n, n, d, seed=seed)


@pytest.mark.parametrize("kind, n, d, seed", CASES)
def test_class_partition_and_table_fill_equal_numpy_and_jax(kind, n, d, seed):
    ja = case(kind, n, d, seed)
    a = to_port(ja)
    ell = tp_ell.EllB.build(a)
    # the native table fill, against the numpy branch and the JAX package's
    ref = tp_ell._fill_tables_numpy(a, ell.class_of_row, ell.widths)
    assert same(ell.tables, ref)
    jell = jx_ell.EllB.build(ja)
    assert same(ell.tables, jell.tables) and same(ell.widths, jell.widths)
    tables = [np.empty_like(t) for t in ell.tables]
    assert jax_native().table_fill(a.indptr, a.indices, ell.class_of_row,
                                   ell.pos_in_class, tables, a.n_cols)
    assert same(tables, ell.tables)
    # the native class partition
    n_cls = len(ell.widths)
    got = native.class_partition(a.indptr, a.indices, ell.class_of_row,
                                 ell.pos_in_class, n_cls)
    assert same(list(got), list(tp_ell._class_entries_numpy(a, ell)))
    assert same(list(got), list(jx_native.class_partition(
        a.indptr, a.indices, ell.class_of_row, ell.pos_in_class, n_cls)))
    assert same(list(tp_ell._build_class_entries(a, ell)),
                list(jx_ell._build_class_entries(ja, jell)))


def test_class_partition_and_table_fill_refuse_what_they_cannot_take():
    a = to_port(jx.BCSR.random(40, 40, 2.0, seed=1))
    ell = tp_ell.EllB.build(a)
    assert native.class_partition(a.indptr, a.indices, ell.class_of_row,
                                  ell.pos_in_class, 0) is None
    assert native.table_fill(a.indptr, a.indices, ell.class_of_row, ell.pos_in_class,
                             [], 40) is None
    with pytest.raises(IndexError, match="out of range"):
        native.class_partition(a.indptr, a.indices, ell.class_of_row[:10],
                               ell.pos_in_class, len(ell.widths))
    with pytest.raises(ValueError, match="int32"):
        native.table_fill(a.indptr, a.indices, ell.class_of_row, ell.pos_in_class,
                          [t.astype(np.int64) for t in ell.tables], 40)


@pytest.mark.parametrize("kind, n, d, seed", CASES)
def test_row_weight_equals_numpy_and_jax(kind, n, d, seed):
    ja = case(kind, n, d, seed)
    a = to_port(ja)
    blen = np.diff(a.indptr).astype(np.int64)
    got = native.row_weight(a.indptr, a.indices, blen)
    assert same(got, tp_sp._row_flops_numpy(a, blen))
    assert same(got, jax_native().row_weight(a.indptr, a.indices, blen))
    assert same(tp_sp.row_flops(a, a), jx_sp.row_flops(ja, ja))
    with pytest.raises(IndexError, match="out of range"):
        native.row_weight(a.indptr, a.indices, blen[:3])


# -- the host engine -----------------------------------------------------------


HOST_CASES = [(120, 90, 150, 3.0, 0), (64, 64, 64, 5.0, 1), (300, 40, 300, 2.0, 2),
              (1, 50, 1, 4.0, 3), (50, 50, 50, 0.0, 4)]


@pytest.mark.parametrize("n, k, m, d, seed", HOST_CASES)
def test_host_products_equal_numpy_and_jax(n, k, m, d, seed):
    ja = jx.BCSR.random(n, k, d, seed=seed)
    jb = jx.BCSR.random(k, m, d, seed=seed + 100)
    jf = jx.BCSR.random(n, m, 2 * d + 1, seed=seed + 200)
    a, b, f = to_port(ja), to_port(jb), to_port(jf)
    c = host.host_spgemm(a, b)
    assert same_csr(host._spgemm_numpy(a, b), c)
    assert same_csr(jx_host.host_spgemm(ja, jb), c)
    mc = host.host_masked_spgemm(f, a, b)
    assert same_csr(host._masked_spgemm_numpy(f, a, b), mc)
    assert same_csr(jx_host.host_masked_spgemm(jf, ja, jb), mc)
    cc, counts = host.host_spgemm_counts(a, b)
    rc, rcounts = host._spgemm_counts_numpy(a, b)
    jc, jcounts = jx_host.host_spgemm_counts(ja, jb)
    assert same_csr(rc, cc) and same_csr(jc, cc)
    assert same(counts, rcounts) and same(counts, jcounts)
    # the helpers themselves, against the JAX package's
    lib = jax_native()
    for got, want in (
            (native.spgemm_host(a.indptr, a.indices, n, m, b.indptr, b.indices,
                                a.flops(b)),
             lib.spgemm_host(a.indptr, a.indices, n, m, b.indptr, b.indices,
                             a.flops(b))),
            (native.spgemm_counts_host(a.indptr, a.indices, n, m, b.indptr, b.indices,
                                       a.flops(b)),
             lib.spgemm_counts_host(a.indptr, a.indices, n, m, b.indptr, b.indices,
                                    a.flops(b))),
            (native.masked_spgemm_host(f.indptr, f.indices, a.indptr, a.indices, n, m,
                                       b.indptr, b.indices, f.nnz),
             lib.masked_spgemm_host(f.indptr, f.indices, a.indptr, a.indices, n, m,
                                    b.indptr, b.indices, f.nnz))):
        assert same(list(got), list(want))


def test_host_products_refuse_a_short_cap_and_bad_operands():
    a = to_port(jx.BCSR.random(60, 60, 4.0, seed=1))
    args = (a.indptr, a.indices, 60, 60, a.indptr, a.indices)
    with pytest.raises(ValueError, match="exceeded cap=5"):
        native.spgemm_host(*args, 5)
    with pytest.raises(ValueError, match="exceeded cap=5"):
        native.spgemm_counts_host(*args, 5)
    with pytest.raises(ValueError, match="exceeded cap=1"):
        native.masked_spgemm_host(a.indptr, a.indices, *args, 1)
    with pytest.raises(IndexError, match="B column id"):
        native.spgemm_host(a.indptr, a.indices, 60, 30, a.indptr, a.indices, 9999)
    with pytest.raises(IndexError, match="A column id"):
        native.spgemm_host(a.indptr, a.indices, 60, 60, a.indptr[:31],
                           a.indices[: a.indptr[30]], 9999)


# -- the wired callers ---------------------------------------------------------


@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
@pytest.mark.parametrize("transpose", [True, False])
def test_read_and_write_pattern_equal_jax(tmp_path, suffix, transpose):
    ja = jx.BCSR.random(300, 250, 3.0, seed=7)
    jp, tp_path = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    jx.write_pattern(jp, ja)
    tp.write_pattern(tp_path, to_port(ja))
    import gzip

    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(jp, "rb") as fj, opener(tp_path, "rb") as ft:
        assert fj.read() == ft.read()
    assert same_csr(jx.read_pattern(jp, transpose=transpose),
                    tp.read_pattern(tp_path, transpose=transpose))
    for rr in ((0, 100), (100, 250), (40, 40)):
        assert same_csr(jx.read_pattern(jp, transpose=transpose, row_range=rr),
                        tp.read_pattern(tp_path, transpose=transpose, row_range=rr))
    with pytest.raises(ValueError, match="interval"):
        tp.read_pattern(tp_path, row_range=(5, 2))


def test_read_pattern_from_an_mmap_equals_jax(tmp_path):
    """A file of 16 MiB or more is parsed from an mmap, in parallel."""
    ja = jx.BCSR.random(60_000, 60_000, 30.0, seed=5)
    p = str(tmp_path / "big.mtx")
    tp.write_pattern(p, to_port(ja))
    assert os.path.getsize(p) >= mmio.MMAP_BYTES
    t = tp.read_pattern(p, transpose=False)
    assert same_csr(ja, t)
    assert same_csr(jx.read_pattern(p), tp.read_pattern(p))
    lo, hi = 12_345, 30_000
    assert same_csr(jx.read_pattern(p, row_range=(lo, hi)),
                    tp.read_pattern(p, row_range=(lo, hi)))


def test_coo_to_csr_stable_equals_jax():
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 700, 20_000)
    cols = rng.integers(0, 900, 20_000)
    from binary_spgemm_tpu.formats.bcsr import coo_to_csr_stable as jx_coo

    assert same(list(tp.coo_to_csr_stable(rows, cols, 700, 900)),
                list(jx_coo(rows, cols, 700, 900)))
    assert same_csr(jx.BCSR.rmat(12, 5.0, seed=4), tp.BCSR.rmat(12, 5.0, seed=4))
    with pytest.raises(ValueError, match="row index out of range"):
        tp.coo_to_csr_stable(np.array([7]), np.array([0]), 3)


def test_size_guards_send_every_caller_to_its_numpy_branch(monkeypatch):
    """Past the int32 domain (lowered here) each guarded helper returns
    ``None`` and its caller takes the numpy branch: the same results."""
    ja = jx.BCSR.rmat(10, 6.0, seed=3)
    jf = jx.BCSR.random(ja.n_rows, ja.n_cols, 4.0, seed=8)
    a, f = to_port(ja), to_port(jf)
    ell = tp_ell.EllB.build(a)
    entries = tp_ell._build_class_entries(a, ell)
    rf = tp_sp.row_flops(a, a)
    products = (host.host_spgemm(a, a), host.host_masked_spgemm(f, a, a),
                host.host_spgemm_counts(a, a))
    monkeypatch.setattr(native, "_INT32_MAX", 100)
    blen = np.diff(a.indptr).astype(np.int64)
    assert native.row_weight(a.indptr, a.indices, blen) is None
    assert native.class_partition(a.indptr, a.indices, ell.class_of_row,
                                  ell.pos_in_class, len(ell.widths)) is None
    assert native.spgemm_host(a.indptr, a.indices, a.n_rows, a.n_cols, a.indptr,
                              a.indices, a.flops(a)) is None
    guarded = tp_ell.EllB.build(a)
    assert same(guarded.tables, ell.tables)
    assert same(list(tp_ell._build_class_entries(a, ell)), list(entries))
    assert same(tp_sp.row_flops(a, a), rf)
    again = (host.host_spgemm(a, a), host.host_masked_spgemm(f, a, a),
             host.host_spgemm_counts(a, a))
    for x, y in zip(products[:2], again[:2]):
        assert same_csr(x, y)
    assert same_csr(products[2][0], again[2][0]) and same(products[2][1], again[2][1])
    monkeypatch.setattr(native, "_UINT32_MAX", 10)
    assert native.spgemm_host(a.indptr, a.indices, a.n_rows, a.n_cols, a.indptr,
                              a.indices, 11) is None
