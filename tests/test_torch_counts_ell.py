"""The port's sliced-ELL counting programs against the JAX package's, on the
CPU: ``run_counts``, ``run_masked_counts`` and ``run_counts_sum`` on the
batched plan (packed keys and pairs), the unrolled contiguous plan and the
dealt one, their outputs element-equal over the valid prefixes, and
``assemble_counts`` bit-exact against the JAX package and scipy's integer
product, on plans with empty rows and trailing group-fill chunks."""
import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import ell as jx_ell

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp

PLAN = ("n_chunks", "rows_pad", "widths", "pads", "sort_pad", "out_pad",
        "group_size", "n_groups")


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def int_oracle(a, b, f=None):
    c = a.to_scipy().astype(np.int64) @ b.to_scipy().astype(np.int64)
    if f is not None:
        c = c.multiply(f.to_scipy().astype(np.int64)).tocsr()
        c.eliminate_zeros()
    c.sort_indices()
    return c


def same_outputs(j_out, t_out):
    """Stacked counting outputs equal: the valid counts, the chunk-local row
    pointers (unrolled), and the index and count streams over each chunk's
    valid prefix."""
    j_out = [np.asarray(x) for x in j_out]
    t_out = [x.numpy() for x in t_out]
    assert [x.shape for x in t_out] == [x.shape for x in j_out]
    assert np.array_equal(t_out[-1], j_out[-1])
    if len(t_out) == 4:
        assert np.array_equal(t_out[0], j_out[0])
    for c, n in enumerate(j_out[-1]):
        for x, y in zip(t_out[-3:-1], j_out[-3:-1]):
            assert np.array_equal(x[c, :n], y[c, :n])


def check_counts_executor(ja, jb, jf, **kw):
    """Plan, ``run_counts`` / ``run_masked_counts`` / ``run_counts_sum``
    outputs and the assembled results of the port's executor equal the JAX
    package's, and the results scipy's."""
    ta, tb, tf = to_port(ja), to_port(jb), to_port(jf)
    jex = jx_ell.EllSpGEMMExecutor(ja, jb, **kw)
    tex = tp_ell.EllSpGEMMExecutor(ta, tb, device="cpu", **kw)
    assert tex.batched == jex.batched
    assert [getattr(tex, f) for f in PLAN] == [getattr(jex, f) for f in PLAN]
    for j_out, t_out, ref in (
            (jex.run_counts(), tex.run_counts(), int_oracle(ta, tb)),
            (jex.run_masked_counts(jf), tex.run_masked_counts(tf), int_oracle(ta, tb, tf))):
        assert len(t_out) == (3 if tex.batched else 4)
        same_outputs(j_out, t_out)
        c, counts = tex.assemble_counts(t_out)
        jc, jcounts = jex.assemble_counts(j_out)
        assert np.array_equal(c.indptr, jc.indptr) and np.array_equal(c.indices, jc.indices)
        assert np.array_equal(counts, jcounts) and counts.dtype == np.int64
        assert np.array_equal(c.indptr, ref.indptr)
        assert np.array_equal(c.indices, ref.indices)
        assert np.array_equal(counts, ref.data)
    sums = tex.run_counts_sum(tf)
    assert sums.shape == (tex.n_groups * tex.group_size,)
    assert np.array_equal(sums.numpy(), np.asarray(jex.run_counts_sum(jf)))
    assert not sums[tex.n_chunks :].any()  # trailing group-fill chunks give 0
    assert int(sums.sum()) == int(int_oracle(ta, tb, tf).sum())
    return tex


@pytest.mark.parametrize("deal_k", [64, 60])
def test_batched_packed(deal_k):
    """Eight dispatch groups; at 60 bins the last group ends in four
    group-fill chunks.  A third of A's rows are empty, so whole output rows
    are empty and their separators sit next to each other."""
    n = 3000
    a = jx.BCSR.random(n, n, 3.0, seed=1)
    keep = np.ones(n, bool)
    keep[::3] = False
    rows, cols = a.to_coo()
    a = jx.BCSR.from_coo(rows[keep[rows]], cols[keep[rows]], a.shape)
    b, f = jx.BCSR.random(n, n, 2.0, seed=2), jx.BCSR.random(n, n, 6.0, seed=3)
    ex = check_counts_executor(a, b, f, batched=True, deal_k=deal_k, masked=True)
    assert ex.n_groups == 8 and ex.n_groups * ex.group_size - ex.n_chunks == 64 - deal_k
    assert tp_sp.packable(ex.rows_pad, 2 * n + 1)


def test_batched_pair_branch():
    """Wide columns and few bins: neither the plain nor the masked key
    packs, so the int64 pair and tagged keys run."""
    n, m = 8000, 262145
    a, b = jx.BCSR.random(n, m, 3.0, seed=1), jx.BCSR.random(m, m, 0.2, seed=2)
    f = jx.BCSR.random(n, m, 2.0, seed=3)
    ex = check_counts_executor(a, b, f, batched=True, deal_k=2)
    assert not tp_sp.packable(ex.rows_pad, m)


@pytest.mark.parametrize("kw", [{"row_chunks": "contig"}, {"row_chunks": "deal", "deal_k": 6},
                                {"deal_k": 5, "masked": True}, {"row_chunks": 1}])
def test_unrolled(kw):
    a = jx.BCSR.rmat(11, 4.0, seed=5)  # skewed rows: the dealt plan's input
    f = jx.BCSR.random(a.n_rows, a.n_cols, 5.0, seed=7)
    ex = check_counts_executor(a, a, f, **kw)
    assert not ex.batched
    assert (ex.row_sets is not None) == ("deal_k" in kw or kw.get("row_chunks") == "deal")


def test_unrolled_general_keys():
    n, m = 600, 1 << 22
    a, b = jx.BCSR.random(n, 500, 3.0, seed=8), jx.BCSR.random(500, m, 2.0, seed=9)
    f = jx.BCSR.random(n, m, 3.0, seed=10)
    ex = check_counts_executor(a, b, f, row_chunks=1)
    assert not tp_sp.packable(ex.rows_pad, m)


def test_counts_sum_is_six_times_the_triangles():
    s = tp.BCSR.random(1500, 1500, 6.0, seed=12).to_scipy()
    s = ((s + s.T) > 0).astype(np.int64).tolil()
    s.setdiag(0)
    g = tp.BCSR.from_scipy(s.tocsr())
    s = g.to_scipy()
    want = int(s.multiply(s @ s).sum())
    assert want % 6 == 0
    for kw in ({"batched": True, "deal_k": 20}, {"row_chunks": "deal"}, {}):
        ex = tp_ell.EllSpGEMMExecutor(g, g, masked=True, device="cpu", **kw)
        sums = ex.run_counts_sum(ex.stage_mask(g))
        assert int(sums[: ex.n_chunks].sum()) == want
