"""The port's one-sort pipeline (``ops/onesort.py``) against the JAX
package's, on the CPU: the same seeded operands through both, the whole
padded streams (``cols`` with their holes, the positional ``indptr_pos``,
``nnz``) element-equal over their full length on the packed, pair-key and
masked branches and through both row-pointer formulations, with hole-y
operands, seeds and masks; ``compact``, ``to_host`` and the flop bound equal;
every product equal to scipy.  Where the JAX package's expansion drops
candidates past ``flops_pad`` the port raises (checked against scipy)."""
import jax
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import onesort as jx_os
from binary_spgemm_tpu.ops import spgemm as jx_sp

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import onesort as tp_os
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.utils.oracle import (
    masked_spgemm_oracle,
    spgemm_oracle,
    union_oracle,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_after_module():
    # the JAX package's device tests drop their executables after the module
    # (an XLA CPU compiler-state workaround); do the same
    yield
    jax.clear_caches()


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def pad_of(mat, pad):
    """``mat`` as a one-sort stream in both packages, its index array padded
    to ``pad`` (so every case of a shape compiles once on the JAX side)."""
    assert mat.nnz <= pad
    return (jx_os.PaddedDeviceBCSR.from_device(jx_sp.DeviceBCSR.from_host(mat, pad_to=pad)),
            tp_os.PaddedDeviceBCSR.from_device(
                tp_sp.DeviceBCSR.from_host(to_port(mat), pad_to=pad, device=CPU)))


def assert_same_stream(j, t):
    """Two one-sort streams element-equal over their whole length."""
    assert tuple(j.shape) == tuple(t.shape)
    assert t.cols.dtype == torch.int32 and t.indptr_pos.dtype == torch.int32
    assert t.nnz.dtype == torch.int32 and t.nnz.dim() == 0
    assert j.stream_len == t.stream_len
    assert np.array_equal(np.asarray(j.cols), t.cols.numpy())
    assert np.array_equal(np.asarray(j.indptr_pos), t.indptr_pos.numpy())
    assert int(j.nnz) == int(t.nnz)


def product(x, y, fp):
    """x·y in both packages: ``(jax stream, port stream)``."""
    return (jx_os.spgemm_onesort_device(x[0], y[0], flops_pad=fp),
            tp_os.spgemm_onesort_device(x[1], y[1], flops_pad=fp))


def fused(d, x, y, fp, mask=None):
    return (jx_os.spgemm_or_onesort_device(d[0], x[0], y[0], flops_pad=fp,
                                           mask=None if mask is None else mask[0]),
            tp_os.spgemm_or_onesort_device(d[1], x[1], y[1], flops_pad=fp,
                                           mask=None if mask is None else mask[1]))


def bound(x, y):
    """The padded-span bound in both packages, held equal; returns it."""
    (jb, jest), (tb, test) = jx_os.flops_bound_onesort(x[0], y[0]), \
        tp_os.flops_bound_onesort(x[1], y[1])
    assert tb.dtype == torch.int32 and test.dtype == torch.float32
    assert int(tb) == int(jb)
    assert float(test) == float(jest)  # small integer sums: exact in float32
    return int(tb)


# (n, k, m, d, index pad, flops_pad).  The row pointers come from the
# histogram at flops_pad 4096 and from the searchsorted at 16384 (300 rows);
# m = 2^22 takes the int64 pair key (and the masked join the tagged key),
# m = 2^20 packs the plain key but not the masked join's.
SHAPES = {
    "packed, histogram": (300, 300, 300, 3.0, 1024, 4096),
    "packed, searchsorted": (300, 300, 300, 3.0, 1024, 16384),
    "pair key": (300, 300, 1 << 22, 3.0, 1024, 4096),
    "masked join unpacked": (300, 300, 1 << 20, 3.0, 1024, 4096),
}


def operands(name, seeds, n_masks=0):
    """A (n x k), B (k x m), then ``n_masks`` n x m matrices (d = 2, 3, ...),
    all canonical, as streams in both packages; and the flops_pad."""
    n, k, m, d, pad, fp = SHAPES[name]
    mats = [jx.BCSR.random(n, k, d, seed=seeds[0]).sum_duplicates(),
            jx.BCSR.random(k, m, d, seed=seeds[1]).sum_duplicates()]
    mats += [jx.BCSR.random(n, m, 2.0 + i, seed=seeds[2 + i]).sum_duplicates()
             for i in range(n_masks)]
    return mats, [pad_of(x, pad) for x in mats], fp


def test_branches_are_the_ones_named():
    assert tp_sp.packable(300, 300) and tp_sp.packable(300, 4 * 300 + 3)
    assert not tp_sp.packable(300, 1 << 22)
    assert tp_sp.packable(300, 1 << 20) and not tp_sp.packable(300, 4 * (1 << 20) + 3)
    assert tp_sp._histogram_indptr_wins(300, 4096)
    assert not tp_sp._histogram_indptr_wins(300, 16384)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("seed", [1, 2])
def test_onesort_product_stream_matches_jax(name, seed):
    (a, b), (pa, pb), fp = operands(name, [seed, seed + 10])
    assert bound(pa, pb) <= fp
    j, t = product(pa, pb, fp)
    assert_same_stream(j, t)
    assert t.stream_len > int(t.nnz)  # there are holes
    assert t.to_host().equals(to_port(spgemm_oracle(a, b)))
    assert t.to_host().equals(to_port(j.to_host()))


@pytest.mark.parametrize("name", ["packed, histogram", "pair key"])
def test_onesort_consumes_holey_operands(name):
    # the second product consumes the first's holes without a compaction
    n, _, m, d, pad, fp = SHAPES[name]
    a = jx.BCSR.random(n, n, d, seed=4).sum_duplicates()
    b = jx.BCSR.random(n, m, d, seed=5).sum_duplicates()
    pa, pb = pad_of(a, pad), pad_of(b, pad)
    p1 = product(pa, pa, fp)  # a² with holes
    assert_same_stream(*p1)
    assert p1[1].stream_len > int(p1[1].nnz)
    fp2 = 1 << 16
    assert bound(p1, pb) <= fp2
    p2 = product(p1, pb, fp2)  # a²·b through a hole-y left operand
    assert_same_stream(*p2)
    a2 = spgemm_oracle(a, a)
    assert p2[1].to_host().equals(to_port(spgemm_oracle(a2, b)))
    if m == n:
        p3 = product(p1, p1, fp2)  # a⁴: hole-y on both sides
        assert_same_stream(*p3)
        assert p3[1].to_host().equals(to_port(spgemm_oracle(a2, a2)))


@pytest.mark.parametrize("name", list(SHAPES))
def test_onesort_fused_or_matches_jax(name):
    (a, b, d), (pa, pb, pd), fp = operands(name, [5, 6, 7], n_masks=1)
    j, t = fused(pd, pa, pb, fp)
    assert_same_stream(j, t)
    assert t.to_host().equals(to_port(union_oracle(d, spgemm_oracle(a, b))))


@pytest.mark.parametrize("name", ["packed, histogram", "pair key"])
def test_onesort_or_with_holey_seed(name):
    # D is itself a hole-y stream (a previous product): the seed join drops
    # its holes like any sentinel
    (a, b), (pa, pb), fp = operands(name, [7, 8])
    d = product(pa, pb, fp)
    j, t = fused(d, pa, pb, fp)
    assert_same_stream(j, t)
    assert t.to_host().equals(to_port(spgemm_oracle(a, b)))  # ab OR ab = ab


@pytest.mark.parametrize("name", ["packed, histogram", "packed, searchsorted",
                                  "pair key"])
def test_padded_compact_and_roundtrip(name):
    (a, b), (pa, pb), fp = operands(name, [8, 9])
    p = product(pa, pb, fp)
    want = to_port(spgemm_oracle(a, b))
    jc, tc = p[0].compact(), p[1].compact()
    assert isinstance(tc, tp_sp.DeviceBCSR)
    assert int(tc.nnz) == int(jc.nnz)
    assert np.array_equal(np.asarray(jc.indptr), tc.indptr.numpy())
    assert np.array_equal(np.asarray(jc.indices), tc.indices.numpy())  # whole pad
    assert tc.to_host().equals(want)
    # a compact result wraps back free and multiplies again
    rw = (jx_os.PaddedDeviceBCSR.from_device(jc), tp_os.PaddedDeviceBCSR.from_device(tc))
    assert_same_stream(*rw)
    if a.shape[1] == b.shape[1]:
        fp2 = 1 << 16
        assert bound(rw, rw) <= fp2
        p2 = product(rw, rw, fp2)
        assert_same_stream(*p2)
        assert p2[1].to_host().equals(to_port(spgemm_oracle(spgemm_oracle(a, b),
                                                            spgemm_oracle(a, b))))


@pytest.mark.parametrize("name", list(SHAPES))
def test_onesort_masked_fused_matches_jax(name):
    # D OR (F .* (A·B)) through one sort, on every key branch
    (a, b, d, f), (pa, pb, pd, pf), fp = operands(name, [20, 21, 22, 23], n_masks=2)
    j, t = fused(pd, pa, pb, fp, mask=pf)
    assert_same_stream(j, t)
    assert t.to_host().equals(to_port(union_oracle(d, masked_spgemm_oracle(f, a, b))))


def test_onesort_masked_holey_operands_and_chain():
    # the mask and the seed are hole-y streams (a previous product); the
    # masked round's output feeds a further unmasked round
    (a, _), (pa, _), fp = operands("packed, histogram", [27, 28])
    p2 = product(pa, pa, fp)  # hole-y a², both mask and seed
    j, t = fused(p2, pa, pa, fp, mask=p2)
    assert_same_stream(j, t)
    a2 = spgemm_oracle(a, a)
    assert t.to_host().equals(to_port(a2))  # a² OR (a² .* a²) = a²
    assert t.stream_len > int(t.nnz)  # the mask's entries became holes
    fp2 = 1 << 17
    assert bound((j, t), (j, t)) <= fp2
    nxt = product((j, t), (j, t), fp2)
    assert_same_stream(*nxt)
    assert nxt[1].to_host().equals(to_port(spgemm_oracle(a2, a2)))


@pytest.mark.parametrize("name", ["packed, histogram", "pair key"])
def test_flops_bound_onesort_matches_jax(name):
    (a, b), (pa, pb), fp = operands(name, [30, 31])
    assert bound(pa, pb) == jx_sp.spgemm_flops(a, b)  # no holes yet
    p = product(pa, pb, fp)
    if a.shape[1] == b.shape[1]:
        # hole-y operand: the bound counts the holes too
        assert bound(p, pb) >= jx_sp.spgemm_flops(spgemm_oracle(a, b), b)


@pytest.mark.parametrize("masked", [False, True])
def test_flops_pad_below_the_padded_bound_raises(masked):
    # one below the padded bound: the JAX package's expansion drops the
    # last candidates and returns a short product; the port raises
    (a, b), (pa, pb), fp = operands("packed, histogram", [40, 41])
    p = product(pa, pa, fp)  # hole-y a²
    need = bound(p, pb)
    jshort = jx_os.spgemm_onesort_device(p[0], pb[0], flops_pad=need - 1)
    want = spgemm_oracle(spgemm_oracle(a, a), b)
    assert int(jshort.nnz) < want.nnz
    with pytest.raises(ValueError, match="flops_pad"):
        if masked:
            tp_os.spgemm_or_onesort_device(p[1], p[1], pb[1], flops_pad=need - 1,
                                           mask=pb[1])
        else:
            tp_os.spgemm_onesort_device(p[1], pb[1], flops_pad=need - 1)
    got = tp_os.spgemm_onesort_device(p[1], pb[1], flops_pad=need)
    assert got.to_host().equals(to_port(want))


def test_inner_dimension_past_the_columns():
    # A (50 x 100) · B (100 x 20): the JAX package tests A's entries against
    # the product's 20 columns, drops those past it and returns a short
    # product; the port tests them against A's own 100 columns (scipy)
    a = jx.BCSR.random(50, 100, 4.0, seed=1).sum_duplicates()
    b = jx.BCSR.random(100, 20, 4.0, seed=2).sum_duplicates()
    pa, pb = pad_of(a, 256), pad_of(b, 512)
    flops = jx_sp.spgemm_flops(a, b)
    jb, _ = jx_os.flops_bound_onesort(pa[0], pb[0])
    assert int(jb) < flops  # the JAX package's bound undercounts
    want = to_port(spgemm_oracle(a, b))
    j = jx_os.spgemm_onesort_device(pa[0], pb[0], flops_pad=flops)
    assert int(j.nnz) < want.nnz  # and its product is short
    tb, test = tp_os.flops_bound_onesort(pa[1], pb[1])
    assert int(tb) == flops and float(test) == flops
    t = tp_os.spgemm_onesort_device(pa[1], pb[1], flops_pad=flops)
    assert t.to_host().equals(want)
    assert t.compact().to_host().equals(want)
    d = jx.BCSR.random(50, 20, 2.0, seed=3).sum_duplicates()
    f = jx.BCSR.random(50, 20, 3.0, seed=4).sum_duplicates()
    got = tp_os.spgemm_or_onesort_device(pad_of(d, 256)[1], pa[1], pb[1],
                                         flops_pad=flops, mask=pad_of(f, 256)[1])
    assert got.to_host().equals(to_port(union_oracle(d, masked_spgemm_oracle(f, a, b))))


def test_empty_operands_match_jax():
    e = jx.BCSR(np.zeros(11, np.int32), np.zeros(0, np.int32), (10, 10))
    pe = pad_of(e, 8)
    assert bound(pe, pe) == 0
    j, t = product(pe, pe, 8)
    assert_same_stream(j, t)
    assert t.to_host().nnz == 0
    assert t.compact().to_host().nnz == 0
    j, t = fused(pe, pe, pe, 8, mask=pe)
    assert_same_stream(j, t)
    assert t.to_host().nnz == 0


def test_shape_and_type_checks():
    b = pad_of(jx.BCSR.random(20, 30, 2.0, seed=13), 64)[1]
    with pytest.raises(ValueError, match="shape"):
        tp_os.spgemm_onesort_device(b, b, flops_pad=8)
    with pytest.raises(TypeError):
        tp_os.spgemm_onesort_device("nope", b, flops_pad=8)
    a = pad_of(jx.BCSR.random(40, 40, 2.0, seed=28), 128)[1]
    bad = pad_of(jx.BCSR.random(30, 30, 2.0, seed=29), 128)[1]
    with pytest.raises(ValueError, match="mask shape"):
        tp_os.spgemm_or_onesort_device(a, a, a, flops_pad=8, mask=bad)
    with pytest.raises(ValueError, match="shape"):
        tp_os.spgemm_or_onesort_device(bad, a, a, flops_pad=8)


def test_device_containers_are_accepted():
    # a compact DeviceBCSR goes in as it is, as in the JAX package
    (a, b), _, fp = operands("packed, histogram", [50, 51])
    da = (jx_sp.DeviceBCSR.from_host(a, pad_to=1024),
          tp_sp.DeviceBCSR.from_host(to_port(a), pad_to=1024, device=CPU))
    db = (jx_sp.DeviceBCSR.from_host(b, pad_to=1024),
          tp_sp.DeviceBCSR.from_host(to_port(b), pad_to=1024, device=CPU))
    j, t = product(da, db, fp)
    assert_same_stream(j, t)
    assert t.to_host().equals(to_port(spgemm_oracle(a, b)))


def test_from_host_defaults_to_cuda():
    a = to_port(jx.BCSR.random(20, 20, 2.0, seed=0))
    if torch.cuda.is_available():
        assert tp_os.PaddedDeviceBCSR.from_host(a).cols.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp_os.PaddedDeviceBCSR.from_host(a)
    p = tp_os.PaddedDeviceBCSR.from_host(a, device=CPU)
    j = jx_os.PaddedDeviceBCSR.from_host(jx.BCSR(a.indptr, a.indices, a.shape))
    assert_same_stream(j, p)
