"""The port's device-resident container and ops (``DeviceBCSR``,
``ops/device_api.py``) against the JAX package's, on the CPU: the same seeded
operands through both, every result exactly equal (row pointers, the valid
indices and counts, nnz, the counts sum) and equal to scipy; the shape
checks, empty operands, ``require_canonical``, ``compact``, and the raise
where the JAX package's expansion drops candidates."""
import jax
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import device_api as jx_api
from binary_spgemm_tpu.ops import spgemm as jx_sp

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import device_api as tp_api
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.utils.oracle import (
    masked_spgemm_oracle,
    spgemm_oracle,
    union_oracle,
)

CPU = "cpu"


def _jit(name):
    """The JAX package's op compiled whole (one XLA program a shape instead
    of one a primitive: the JAX side's compile time is this file's cost)."""
    fn = getattr(jx_api, name)
    return jax.jit(fn, static_argnames=("flops_pad",) if name != "spm_or_device" else ())


JX = {name: _jit(name) for name in jx_api.__all__ if name != "flops_bound_device"}


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_after_module():
    # the JAX package's device-API tests drop their executables after the
    # module (an XLA CPU compiler-state workaround); do the same
    yield
    jax.clear_caches()


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def stage(*mats, canonical=False, pad=None):
    """Each matrix staged by both packages (index arrays padded to ``pad``):
    ``[(jax DeviceBCSR, port DeviceBCSR), ...]``."""
    return [(jx_sp.DeviceBCSR.from_host(m, pad_to=pad, require_canonical=canonical),
             tp_sp.DeviceBCSR.from_host(to_port(m), pad_to=pad,
                                        require_canonical=canonical, device=CPU))
            for m in mats]


def assert_same_device(j, t, with_tail=True):
    """A JAX and a port DeviceBCSR: equal shape, row pointers, nnz and valid
    indices (and, ``with_tail``, the whole padded index array)."""
    assert tuple(j.shape) == tuple(t.shape)
    assert t.indptr.dtype == torch.int32 and t.indices.dtype == torch.int32
    assert t.nnz.dtype == torch.int32 and t.nnz.dim() == 0
    nnz = int(j.nnz)
    assert int(t.nnz) == nnz
    assert np.array_equal(np.asarray(j.indptr), t.indptr.numpy())
    ji, ti = np.asarray(j.indices), t.indices.numpy()
    assert ji.shape == ti.shape
    assert np.array_equal(ji[:nnz], ti[:nnz])
    if with_tail:
        assert np.array_equal(ji, ti)


def int_oracle(a, b, f=None):
    c = a.to_scipy().astype(np.int64) @ b.to_scipy().astype(np.int64)
    if f is not None:
        c = c.multiply(f.to_scipy().astype(np.int64)).tocsr()
        c.eliminate_zeros()
    c.sort_indices()
    return c


def sym_graph(n, d, seed):
    sp = jx.BCSR.random(n, n, d, seed=seed).to_scipy()
    sp = ((sp + sp.T) > 0).astype(np.int64).tolil()
    sp.setdiag(0)
    return jx.BCSR.from_scipy(sp.tocsr())


# (n, k, m, d, index pad, flops_pad): packed keys, and a column count past
# the int32 key.  Every case of a shape stages to the same pads, so the JAX
# side compiles each op once a shape.
SHAPES = [(300, 300, 300, 3.0, 1024, 4096), (90, 80, 1 << 22, 2.0, 512, 512)]


def operands(shape, seeds, canonical=False, masks=0):
    """A (n x k), B (k x m) and ``masks`` canonical n x m matrices from
    ``seeds``, staged by both packages at the shape's pads; the flops_pad."""
    n, k, m, d, pad, fp = shape
    mats = [jx.BCSR.random(n, k, d, seed=seeds[0]),
            jx.BCSR.random(k, m, d, seed=seeds[1])]
    if canonical:
        mats = [x.sum_duplicates() for x in mats]
    mats += [jx.BCSR.random(n, m, 2.0 + i, seed=seeds[2 + i]).sum_duplicates()
             for i in range(masks)]
    assert jx_sp.spgemm_flops(mats[0], mats[1]) <= fp
    assert max(x.nnz for x in mats) <= pad
    return mats, stage(*mats, canonical=canonical, pad=pad), fp


@pytest.mark.parametrize("pad", [None, "wide"])
def test_device_roundtrip_matches_jax(pad):
    a = jx.BCSR.random(100, 80, 3.0, seed=0)
    pad_to = None if pad is None else jx_sp.pad_bucket(a.nnz) * 8
    j = jx_sp.DeviceBCSR.from_host(a, pad_to=pad_to)
    t = tp_sp.DeviceBCSR.from_host(to_port(a), pad_to=pad_to, device=CPU)
    assert_same_device(j, t)
    assert t.to_host().equals(to_port(a))


def test_entry_points_default_to_cuda():
    a = to_port(jx.BCSR.random(20, 20, 2.0, seed=0))
    if torch.cuda.is_available():
        assert tp_sp.DeviceBCSR.from_host(a).indices.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp_sp.DeviceBCSR.from_host(a)


@pytest.mark.parametrize("seed", [1, 2])
def test_flops_bound_device_matches_jax(seed):
    a = jx.BCSR.random(200, 200, 4.0, seed=seed)
    (ja, ta), = stage(a)
    got = tp_api.flops_bound_device(ta, ta)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(jx_api.flops_bound_device(ja, ja)) == jx_sp.spgemm_flops(a, a)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [2, 3])
def test_spgemm_device_matches_jax(shape, seed):
    (a, b), ((ja, ta), (jb, tb)), fp = operands(shape, [seed, seed + 10])
    j = JX["spgemm_device"](ja, jb, flops_pad=fp)
    t = tp_api.spgemm_device(ta, tb, flops_pad=fp)
    assert_same_device(j, t)
    assert t.to_host().equals(to_port(spgemm_oracle(a, b)))


def test_device_chain_matches_jax():
    # (A·B) OR X with no host sync in between
    (a, b, x), ((ja, ta), (jb, tb), (jx_, tx)), fp = operands(SHAPES[0], [3, 13, 23],
                                                              masks=1)
    j = JX["spm_or_device"](JX["spgemm_device"](ja, jb, flops_pad=fp), jx_)
    t = tp_api.spm_or_device(tp_api.spgemm_device(ta, tb, flops_pad=fp), tx)
    assert_same_device(j, t)
    assert t.to_host().equals(to_port(union_oracle(spgemm_oracle(a, b), x)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_spgemm_or_device_matches_jax(shape, masked):
    (a, b, dm, f), ((ja, ta), (jb, tb), (jd, td), (jf, tf)), fp = operands(
        shape, [4, 5, 6, 7], masks=2)
    j = JX["spgemm_or_device"](jd, ja, jb, flops_pad=fp, mask=jf if masked else None)
    t = tp_api.spgemm_or_device(td, ta, tb, flops_pad=fp, mask=tf if masked else None)
    assert_same_device(j, t)
    prod = masked_spgemm_oracle(f, a, b) if masked else spgemm_oracle(a, b)
    assert t.to_host().equals(to_port(union_oracle(dm, prod)))


@pytest.mark.parametrize("shape", SHAPES)
def test_masked_spgemm_device_matches_jax(shape):
    (a, b, f), ((ja, ta), (jb, tb), (jf, tf)), fp = operands(shape, [7, 8, 9],
                                                             masks=1)
    j = JX["masked_spgemm_device"](jf, ja, jb, flops_pad=fp)
    t = tp_api.masked_spgemm_device(tf, ta, tb, flops_pad=fp)
    assert_same_device(j, t)
    assert t.to_host().equals(to_port(masked_spgemm_oracle(f, a, b)))


def test_device_compact_matches_jax():
    a = jx.BCSR.random(200, 200, 3.0, seed=9)
    wide = jx_sp.pad_bucket(a.nnz) * 8
    j = jx_sp.DeviceBCSR.from_host(a, pad_to=wide)
    t = tp_sp.DeviceBCSR.from_host(to_port(a), pad_to=wide, device=CPU)
    jc, tc = j.compact(), t.compact()
    assert tc.indices.shape[0] < t.indices.shape[0]
    assert_same_device(jc, tc)
    assert tc.to_host().equals(to_port(a))
    assert t.compact(pad_to=t.indices.shape[0] * 2) is t  # no-op when wider


def test_device_compact_truncation_raises():
    t = tp_sp.DeviceBCSR.from_host(to_port(jx.BCSR.random(100, 100, 3.0, seed=10)),
                                   device=CPU)
    with pytest.raises(ValueError, match="truncate"):
        t.compact(pad_to=8)


@pytest.mark.parametrize("shape", SHAPES)
def test_spgemm_counts_device_matches_jax(shape):
    (a, b), ((ja, ta), (jb, tb)), fp = operands(shape, [8, 9], canonical=True)
    jc, jcnt = JX["spgemm_counts_device"](ja, jb, flops_pad=fp)
    tc, tcnt = tp_api.spgemm_counts_device(ta, tb, flops_pad=fp)
    assert_same_device(jc, tc, with_tail=False)
    nnz = int(tc.nnz)
    assert np.array_equal(np.asarray(jcnt)[:nnz], tcnt.numpy()[:nnz])
    ref = int_oracle(a, b)
    c = tc.to_host()
    assert np.array_equal(c.indptr, ref.indptr) and np.array_equal(c.indices, ref.indices)
    assert np.array_equal(tcnt.numpy()[:nnz], ref.data)


@pytest.mark.parametrize("shape", SHAPES)
def test_masked_spgemm_counts_device_matches_jax(shape):
    (a, b, f), ((ja, ta), (jb, tb), (jf, tf)), fp = operands(
        shape, [5, 6, 7], canonical=True, masks=1)
    jc, jcnt = JX["masked_spgemm_counts_device"](jf, ja, jb, flops_pad=fp)
    tc, tcnt = tp_api.masked_spgemm_counts_device(tf, ta, tb, flops_pad=fp)
    assert_same_device(jc, tc, with_tail=False)
    nnz = int(tc.nnz)
    assert np.array_equal(np.asarray(jcnt)[:nnz], tcnt.numpy()[:nnz])
    ref = int_oracle(a, b, f)
    c = tc.to_host()
    assert np.array_equal(c.indptr, ref.indptr) and np.array_equal(c.indices, ref.indices)
    assert np.array_equal(tcnt.numpy()[:nnz], ref.data)


@pytest.mark.parametrize("seed", [3, 4])
def test_counts_sum_device_matches_jax(seed):
    g = sym_graph(300, 3.0, seed)
    (jg, tg), = stage(g, canonical=True, pad=2048)
    fp = 16384
    assert g.nnz <= 2048 and jx_sp.spgemm_flops(g, g) <= fp
    got = tp_api.counts_sum_device(tg, tg, tg, flops_pad=fp)
    assert got.dtype == torch.int32 and got.dim() == 0
    s = int(got)
    assert s == int(JX["counts_sum_device"](jg, jg, jg, flops_pad=fp))
    gi = g.to_scipy().astype(np.int64)
    assert s == int((gi @ gi).multiply(gi).sum()) and s % 6 == 0


def test_from_host_require_canonical():
    dup = tp.BCSR.from_coo(np.array([0, 0, 1]), np.array([2, 2, 1]), (2, 3))
    tp_sp.DeviceBCSR.from_host(dup, device=CPU)  # the boolean family: fine
    with pytest.raises(ValueError, match="canonical"):
        tp_sp.DeviceBCSR.from_host(dup, require_canonical=True, device=CPU)
    tp_sp.DeviceBCSR.from_host(dup.sum_duplicates(), require_canonical=True, device=CPU)


def _call(op, ta, tb, tf):
    fp = 64
    return {
        "spgemm": lambda: tp_api.spgemm_device(ta, tb, flops_pad=fp),
        "spm_or": lambda: tp_api.spm_or_device(ta, tb),
        "spgemm_or": lambda: tp_api.spgemm_or_device(tf, ta, tb, flops_pad=fp),
        "spgemm_or mask": lambda: tp_api.spgemm_or_device(ta, ta, ta, flops_pad=fp,
                                                          mask=tb),
        "masked": lambda: tp_api.masked_spgemm_device(tf, ta, tb, flops_pad=fp),
        "counts": lambda: tp_api.spgemm_counts_device(ta, tb, flops_pad=fp),
        "masked counts": lambda: tp_api.masked_spgemm_counts_device(tf, ta, tb,
                                                                    flops_pad=fp),
        "counts sum": lambda: tp_api.counts_sum_device(tf, ta, tb, flops_pad=fp),
    }[op]()


OPS = ["spgemm", "spm_or", "spgemm_or", "spgemm_or mask", "masked", "counts",
       "masked counts", "counts sum"]


@pytest.mark.parametrize("op", OPS)
def test_shape_checks(op):
    # a is 20x30; b is 20x30 (so a @ b and a vs b mismatch); f is 20x20
    a = tp_sp.DeviceBCSR.from_host(to_port(jx.BCSR.random(20, 30, 2.0, seed=1)),
                                   device=CPU)
    b = tp_sp.DeviceBCSR.from_host(to_port(jx.BCSR.random(20 if op != "spm_or" else 30,
                                                          30, 2.0, seed=2)), device=CPU)
    f = tp_sp.DeviceBCSR.from_host(to_port(jx.BCSR.random(20, 20, 2.0, seed=3)),
                                   device=CPU)
    with pytest.raises(ValueError, match="shape"):
        _call(op, a, b, f)


@pytest.mark.parametrize("op", OPS)
def test_empty_operands_match_jax(op):
    n, _, _, d, pad, fp = SHAPES[0]
    e = jx.BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, n))
    a = jx.BCSR.random(n, n, d, seed=4).sum_duplicates()
    (je, te), (ja, ta) = stage(e, a, canonical=True, pad=pad)
    jfn = {"spgemm": lambda: JX["spgemm_device"](je, ja, flops_pad=fp),
           "spm_or": lambda: JX["spm_or_device"](je, je),
           "spgemm_or": lambda: JX["spgemm_or_device"](ja, je, ja, flops_pad=fp),
           "spgemm_or mask": lambda: JX["spgemm_or_device"](je, ja, ja, flops_pad=fp,
                                                             mask=je),
           "masked": lambda: JX["masked_spgemm_device"](ja, ja, je, flops_pad=fp),
           "counts": lambda: JX["spgemm_counts_device"](ja, je, flops_pad=fp),
           "masked counts": lambda: JX["masked_spgemm_counts_device"](
               je, ja, ja, flops_pad=fp),
           "counts sum": lambda: JX["counts_sum_device"](ja, je, ja, flops_pad=fp)}[op]
    tfn = {"spgemm": lambda: tp_api.spgemm_device(te, ta, flops_pad=fp),
           "spm_or": lambda: tp_api.spm_or_device(te, te),
           "spgemm_or": lambda: tp_api.spgemm_or_device(ta, te, ta, flops_pad=fp),
           "spgemm_or mask": lambda: tp_api.spgemm_or_device(te, ta, ta, flops_pad=fp,
                                                             mask=te),
           "masked": lambda: tp_api.masked_spgemm_device(ta, ta, te, flops_pad=fp),
           "counts": lambda: tp_api.spgemm_counts_device(ta, te, flops_pad=fp),
           "masked counts": lambda: tp_api.masked_spgemm_counts_device(
               te, ta, ta, flops_pad=fp),
           "counts sum": lambda: tp_api.counts_sum_device(ta, te, ta, flops_pad=fp)}[op]
    j, t = jfn(), tfn()
    if op == "counts sum":
        assert int(t) == int(j) == 0
        return
    if isinstance(t, tuple):
        (j, jcnt), (t, tcnt) = j, t
    assert_same_device(j, t, with_tail=False)
    want = a if op == "spgemm_or" else e
    assert t.to_host().equals(to_port(want))


@pytest.mark.parametrize("op", ["spgemm", "spgemm_or", "masked", "counts",
                                "masked counts", "counts sum"])
def test_flops_pad_below_the_product_raises(op):
    # the JAX package keeps the first flops_pad candidates and returns a short
    # product; the port raises (checked against scipy, not JAX)
    n, _, _, d, pad, _ = SHAPES[0]
    a = jx.BCSR.random(n, n, d, seed=11).sum_duplicates()
    flops = jx_sp.spgemm_flops(a, a)
    (ja, ta), = stage(a, canonical=True, pad=pad)
    jc = JX["spgemm_device"](ja, ja, flops_pad=flops - 1)
    assert int(jc.nnz) < spgemm_oracle(a, a).nnz  # JAX's short product
    fp = {"spgemm": tp_api.spgemm_device, "counts": tp_api.spgemm_counts_device}
    with pytest.raises(ValueError, match="flops_pad"):
        if op in fp:
            fp[op](ta, ta, flops_pad=flops - 1)
        elif op == "spgemm_or":
            tp_api.spgemm_or_device(ta, ta, ta, flops_pad=flops - 1)
        else:
            {"masked": tp_api.masked_spgemm_device,
             "masked counts": tp_api.masked_spgemm_counts_device,
             "counts sum": tp_api.counts_sum_device}[op](ta, ta, ta, flops_pad=flops - 1)
    # at the exact bound every op agrees with scipy
    c = tp_api.spgemm_device(ta, ta, flops_pad=flops)
    assert c.to_host().equals(to_port(spgemm_oracle(a, a)))
