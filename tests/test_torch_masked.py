"""The port's masked product C = F .* (A·B) against the JAX package's, on the
CPU: the sort-fused mask join (packed and three-key, 1-D and batched), the
``masked=True`` plans, the staged masks, the assembled streams, the
``run_masked`` outputs over their valid prefixes, and ``masked_spgemm`` on
every route (host, batched packed and pair, unrolled contiguous and dealt,
chunked ESC), each bit-exact against the JAX package and scipy."""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import ell as jx_ell
from binary_spgemm_tpu.ops import masked as jx_masked
from binary_spgemm_tpu.ops import spgemm as jx_sp

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import host as tp_host
from binary_spgemm_tpu_torch.ops import masked as tp_masked
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.utils.oracle import masked_spgemm_oracle, spgemm_oracle

PLAN = ("n_chunks", "rows_pad", "widths", "pads", "inline", "sort_pad",
        "out_pad", "group_size", "n_groups")


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def assert_same(j, t):
    assert np.array_equal(j.indptr, t.indptr)
    assert np.array_equal(j.indices, t.indices)


def t_(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def j_(*xs):
    return [jnp.asarray(x) for x in xs]


def join_case(n_rows, n_cols, L, P, seed, k=None):
    """Candidate pairs (some equal to mask pairs, duplicates, an ``(n_rows,
    n_cols)`` sentinel tail, one separator per row) and canonical mask
    pairs padded past ``f_nnz``; with ``k``, ``[k, ·]`` stacks."""
    rng = np.random.default_rng(seed)
    shape = (L,) if k is None else (k, L)
    row = rng.integers(0, n_rows, shape).astype(np.int32)
    col = rng.integers(0, n_cols, shape).astype(np.int32)
    f_shape = (P,) if k is None else (k, P)
    keys = np.sort(rng.integers(0, n_rows * n_cols, f_shape), axis=-1)
    f_row, f_col = (keys // n_cols).astype(np.int32), (keys % n_cols).astype(np.int32)
    hit = L // 4
    row[..., :hit], col[..., :hit] = f_row[..., :hit], f_col[..., :hit]  # in F
    row[..., hit : 2 * hit] = row[..., :hit]  # duplicates
    col[..., hit : 2 * hit] = col[..., :hit]
    row[..., -(L // 8):], col[..., -(L // 8):] = n_rows, n_cols  # sentinels
    seps = min(n_rows, L // 8)
    row[..., -(L // 8) - seps : -(L // 8)] = np.arange(seps)
    col[..., -(L // 8) - seps : -(L // 8)] = n_cols
    return row, col, f_row, f_col


# packed (masked key fits int32) and three-key (it does not); n_rows 37 at
# ~200 slots takes the histogram, 6 the searchsorted; 2^29 columns make the
# pairs unpackable
JOIN_CASES = [(37, 53), (6, 53), (37, 1 << 29), (6, 1 << 29), ((1 << 19) - 1, 1023)]


@pytest.mark.parametrize("n_rows,n_cols", JOIN_CASES)
def test_sort_compress_masked_matches_jax(n_rows, n_cols):
    row, col, f_row, f_col = join_case(n_rows, n_cols, 200, 60, n_rows + 7)
    f_nnz = 45  # mask slots past it are ignored
    j = jx_sp.sort_compress_masked(*j_(row, col, f_row, f_col), jnp.int32(f_nnz),
                                   n_rows, n_cols)
    t = tp_sp.sort_compress_masked(*t_(row, col, f_row, f_col), f_nnz, n_rows, n_cols)
    nnz = int(j[2])
    assert int(t[2]) == nnz and t[0].dtype == torch.int32 and t[1].dtype == torch.int32
    assert np.array_equal(np.asarray(j[0]), t[0].numpy())
    assert t[1].shape == (len(row) + len(f_row),)
    assert np.array_equal(np.asarray(j[1])[:nnz], t[1].numpy()[:nnz])
    # against the definition
    fset = set(zip(f_row[:f_nnz].tolist(), f_col[:f_nnz].tolist()))
    want = sorted({p for p in zip(row.tolist(), col.tolist()) if p in fset})
    assert nnz == len(want)
    j_sep = jx_sp.sort_compress_masked_seps(*j_(row, col, f_row, f_col),
                                            jnp.int32(f_nnz), n_rows, n_cols)
    t_sep = tp_sp.sort_compress_masked_seps(*t_(row, col, f_row, f_col), f_nnz,
                                            n_rows, n_cols)
    nnz = int(j_sep[1])
    assert int(t_sep[1]) == nnz
    assert np.array_equal(np.asarray(j_sep[0])[:nnz], t_sep[0].numpy()[:nnz])


@pytest.mark.parametrize("n_rows,n_cols", JOIN_CASES)
def test_sort_compress_masked_seps_2d_matches_jax(n_rows, n_cols):
    row, col, f_row, f_col = join_case(n_rows, n_cols, 160, 48, n_rows + 3, k=5)
    f_row[:, 40:], f_col[:, 40:] = n_rows, n_cols  # staged padding sentinels
    j_idx, j_nnz = (np.asarray(x) for x in jx_sp.sort_compress_masked_seps_2d(
        *j_(row, col, f_row, f_col), n_rows, n_cols))
    outs = [tp_sp.sort_compress_masked_seps_2d(*t_(row, col, f_row, f_col),
                                               n_rows, n_cols)]
    if jx_sp.packable(n_rows, 2 * n_cols + 1):
        bl = int(n_cols).bit_length()
        key = (row << bl) | col
        j_k = jx_sp.sort_compress_masked_seps_2d_keys(*j_(key, f_row, f_col), n_rows, n_cols)
        assert np.array_equal(np.asarray(j_k[1]), j_nnz)
        outs.append(tp_sp.sort_compress_masked_seps_2d_keys(*t_(key, f_row, f_col),
                                                            n_rows, n_cols))
    for t_idx, t_nnz in outs:
        assert t_idx.shape == j_idx.shape and np.array_equal(t_nnz.numpy(), j_nnz)
        for r in range(5):
            assert np.array_equal(t_idx[r, : j_nnz[r]].numpy(), j_idx[r, : j_nnz[r]])


def test_tagged_sort_past_63_bits():
    """Where ``(row, col, tag)`` does not fit one int64 key, two stable sorts
    give the same lexicographic order."""
    big = (1 << 31) - 2
    rng = np.random.default_rng(3)
    rows = rng.choice([0, 5, big - 1, big], 300).astype(np.int32)
    cols = rng.choice([0, 7, big - 3, big], 300).astype(np.int32)
    tags = rng.integers(0, 2, 300)
    blocks = [(torch.from_numpy(rows[tags == t]), torch.from_numpy(cols[tags == t]),
               int(t)) for t in (1, 0)]
    r, c, g = tp_sp._sort_tagged(blocks, big, big, 1)
    order = np.lexsort((tags, cols, rows))
    assert np.array_equal(r.numpy(), rows[order])
    assert np.array_equal(c.numpy(), cols[order])
    assert np.array_equal(g.numpy(), tags[order])


@pytest.mark.parametrize("n,m,d,seed", [(300, 300, 3.0, 1), (1000, 1 << 20, 2.0, 2)])
def test_masked_spgemm_padded_matches_jax(n, m, d, seed):
    a = jx.BCSR.random(n, n if m > n else m, d, seed=seed)
    b = jx.BCSR.random(a.n_cols, m, d, seed=seed + 1)
    f = jx.BCSR.random(n, m, 4.0 * d, seed=seed + 2)
    flops_pad = jx_sp.pad_bucket(jx_sp.spgemm_flops(a, b))
    f_idx = np.full(f.nnz + 9, m, np.int32)
    f_idx[: f.nnz] = f.indices
    args = (f.indptr.astype(np.int32), f_idx, a.indptr.astype(np.int32), a.indices)
    j = jx_masked.masked_spgemm_padded(
        *j_(*args), jnp.int32(a.nnz), *j_(b.indptr.astype(np.int32), b.indices),
        n_cols=m, flops_pad=flops_pad)
    t = tp_masked.masked_spgemm_padded(
        *t_(*args), a.nnz, *t_(b.indptr.astype(np.int32), b.indices),
        n_cols=m, flops_pad=flops_pad)
    nnz = int(j[2])
    assert int(t[2]) == nnz and np.array_equal(np.asarray(j[0]), t[0].numpy())
    assert np.array_equal(np.asarray(j[1])[:nnz], t[1].numpy()[:nnz])


def group_inputs(mod, ex, to_np):
    """Each dispatch group's assembled plain stream (keys where the masked
    key packs, else pairs), rebuilt with ``mod``'s own functions."""
    tables = mod._unpack_tables(ex.tables_flat, ex.table_shapes)
    spans = tuple(p * w if s is None else p
                  for s, w, p in zip(ex.table_shapes, ex.widths, ex.pads))
    packed = tp_sp.packable(ex.rows_pad, 2 * ex.n_cols + 1)
    shift = int(ex.n_cols).bit_length() if packed else None
    out = []
    for row0 in ex._row0s():
        er, ep = mod._unpack_entries(ex.er_all, ex.ep_all, row0, ex.group_size,
                                     ex.pads, spans)
        s = mod._assemble_stream_2d(tables, er, ep, ex.group_size, ex.rows_pad,
                                    ex.n_cols, ex.widths, ex.pads, ex.sort_pad,
                                    shift=shift)
        out.append([to_np(x) for x in ((s,) if packed else s)])
    return out


def check_masked_executor(ja, jb, jf, run=True, **kw):
    """Plan, staged arrays and mask, streams, ``run_masked`` outputs and the
    CSR of the port's executor equal the JAX package's, and the CSR scipy's
    (``run=False``: the plan, staging and streams only)."""
    ta, tb, tf = to_port(ja), to_port(jb), to_port(jf)
    jex = jx_ell.EllSpGEMMExecutor(ja, jb, **kw)
    tex = tp_ell.EllSpGEMMExecutor(ta, tb, device="cpu", **kw)
    assert tex.batched == jex.batched
    assert [getattr(tex, f) for f in PLAN] == [getattr(jex, f) for f in PLAN]
    if jex.batched:
        assert tex.k_ranking == jex.k_ranking
    for name in ("tables_flat", "er_all", "ep_all"):
        assert np.array_equal(getattr(tex, name).numpy(), np.asarray(getattr(jex, name)))
    assert tex.staged_nnz_pad(tf) == jex.staged_nnz_pad(jf)
    j_st, t_st = jex.stage_mask(jf), tex.stage_mask(tf)
    for j, t in zip(j_st, t_st):
        assert t.dtype == torch.int32 and np.array_equal(np.asarray(j), t.numpy())
    # the staged mask's pairs, group by group
    for row0 in tex._row0s():
        g = slice(row0, row0 + tex.group_size)
        j = jx_ell._staged_pairs_2d(j_st[0][g], j_st[1][g], jex.rows_pad, jex.n_cols)
        t = tp_ell._staged_pairs_2d(t_st[0][g], t_st[1][g], tex.rows_pad, tex.n_cols)
        assert all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(j, t))
    if jex.batched:
        for jp, tp_ in zip(group_inputs(jx_ell, jex, np.asarray),
                           group_inputs(tp_ell, tex, lambda x: x.numpy())):
            assert all(np.array_equal(x, y) for x, y in zip(jp, tp_))
    if not run:
        return tex
    j_out, t_out = jex.run_masked(j_st), tex.run_masked(t_st)
    j_idx, j_nnz = (np.asarray(x) for x in j_out)
    t_idx, t_nnz = (x.numpy() for x in t_out)
    assert t_idx.shape == j_idx.shape and np.array_equal(t_nnz, j_nnz)
    for c in range(len(t_nnz)):
        assert np.array_equal(t_idx[c, : t_nnz[c]], j_idx[c, : j_nnz[c]])
    c = tex.assemble(t_out)
    assert_same(jex.assemble(j_out), c)
    assert c.equals(masked_spgemm_oracle(tf, ta, tb))
    assert tex.assemble(tex.run_masked(tf)).equals(c)  # a BCSR mask, staged here
    return tex


@pytest.mark.parametrize("masked", [False, True])
def test_batched_packed(masked):
    n = 3000
    a, b = jx.BCSR.random(n, n, 3.0, seed=1), jx.BCSR.random(n, n, 2.0, seed=2)
    f = jx.BCSR.random(n, n, 4.0, seed=3)
    ex = check_masked_executor(a, b, f, batched=True, deal_k=64, masked=masked)
    assert tp_sp.packable(ex.rows_pad, 2 * n + 1)


def test_batched_pair_branch():
    """Wide columns and few bins: the masked key does not pack, so the
    three-key join runs (the JAX package's test_batched_op_family_unpacked)."""
    n, m = 8000, 262145
    a, b = jx.BCSR.random(n, m, 3.0, seed=1), jx.BCSR.random(m, m, 0.2, seed=2)
    f = jx.BCSR.random(n, m, 2.0, seed=3)
    ex = check_masked_executor(a, b, f, batched=True, deal_k=4)
    assert not tp_sp.packable(ex.rows_pad, 2 * m + 1)


def test_masked_plan_differs_from_the_plain_one():
    """At n = 30000, d = 12 the masked batched plan (no cliff refinement,
    the gather model's rates) picks another bin count than the plain one;
    both equal the JAX package's."""
    a = jx.BCSR.random(30000, 30000, 12.0, seed=3)
    f = jx.BCSR.random(30000, 30000, 2.0, seed=4)
    ex = check_masked_executor(a, a, f, run=False, batched=True, masked=True)
    plain = tp_ell.EllSpGEMMExecutor(to_port(a), to_port(a), batched=True, device="cpu")
    assert ex.n_chunks != plain.n_chunks
    assert tp_sp.packable(ex.rows_pad, 2 * a.n_cols + 1)


@pytest.mark.parametrize("kw", [{}, {"masked": True}, {"row_chunks": 1},
                                {"deal_k": 16, "masked": True}])
def test_unrolled(kw):
    n = 2500
    a, b = jx.BCSR.random(n, n, 3.0, seed=5), jx.BCSR.random(n, n, 2.5, seed=6)
    f = jx.BCSR.random(n, n, 5.0, seed=7)
    ex = check_masked_executor(a, b, f, **kw)
    assert not ex.batched
    assert (ex.row_sets is not None) == ("deal_k" in kw)


def test_unrolled_three_key():
    n, m = 600, 1 << 22
    a, b = jx.BCSR.random(n, 500, 3.0, seed=8), jx.BCSR.random(500, m, 2.0, seed=9)
    f = jx.BCSR.random(n, m, 3.0, seed=10)
    ex = check_masked_executor(a, b, f, row_chunks=1)
    assert not tp_sp.packable(ex.rows_pad, 2 * m + 1)


def test_masked_plan_fields():
    """``masked=True`` halves the chunk row cap and widens ``key_cols`` as
    the JAX package's plan does: here the unrolled plan splits into more
    chunks than the plain one."""
    n, m = 70000, 1 << 14
    a = jx.BCSR.random(n, 300, 1.0, seed=11)
    b = jx.BCSR.random(300, m, 1.0, seed=12)
    for masked in (False, True):
        jex = jx_ell.EllSpGEMMExecutor(a, b, masked=masked, row_chunks="contig")
        tex = tp_ell.EllSpGEMMExecutor(to_port(a), to_port(b), masked=masked,
                                       row_chunks="contig", device="cpu")
        assert [getattr(tex, f) for f in PLAN] == [getattr(jex, f) for f in PLAN]
        assert tex.chunks == jex.chunks
    plain = tp_ell.EllSpGEMMExecutor(to_port(a), to_port(b), row_chunks="contig",
                                     device="cpu")
    assert tex.n_chunks > plain.n_chunks


def test_stage_mask_cache_checks_identity():
    a = tp.BCSR.random(2000, 2000, 3.0, seed=21)
    ex = tp_ell.EllSpGEMMExecutor(a, a, batched=True, deal_k=32, device="cpu")
    f = tp.BCSR.random(2000, 2000, 2.0, seed=22)
    staged = ex.stage_mask(f)
    assert ex.stage_mask(f) is staged
    assert ex.assemble(ex.run_masked(staged)).equals(ex.assemble(ex.run_masked(f)))
    # a freed mask's id may be reused by another matrix: the weakref check
    # restages instead of returning the stale arrays
    fid = id(f)
    del f, staged
    gc.collect()
    g = tp.BCSR.random(2000, 2000, 1.0, seed=23)
    ex._mask_cache[id(g)] = ex._mask_cache.pop(fid)  # as if g took f's id
    got = ex.stage_mask(g)
    assert got[1].shape[1] == ex.staged_nnz_pad(g)
    assert ex.assemble(ex.run_masked(got)).equals(masked_spgemm_oracle(g, a, a))
    with pytest.raises(ValueError, match="mask shape"):
        ex.stage_mask(tp.BCSR.random(2000, 1999, 1.0, seed=1))


def test_pad_rowset_csr_all_matches_jax():
    a = jx.BCSR.random(400, 300, 3.0, seed=4)
    rng = np.random.default_rng(4)
    perm = rng.permutation(400)
    row_sets = [perm[:150], perm[150:151], perm[151:151], perm[151:]]
    ptr, idx = tp_ell._pad_rowset_csr_all(to_port(a), row_sets, 256, 900, fill=300)
    for i, rows in enumerate(row_sets):
        jp, ji, _ = jx_ell._pad_rowset_csr(a, rows, 256, 900, fill=300)
        assert np.array_equal(ptr[i], jp) and np.array_equal(idx[i], ji)


def masked_routes(monkeypatch, route):
    """Record which engine ``masked_spgemm`` took."""
    taken = []
    real_host = tp_host.host_masked_spgemm
    monkeypatch.setattr(tp_host, "host_masked_spgemm",
                        lambda *a: taken.append("host") or real_host(*a))
    real_run = tp_ell.EllSpGEMMExecutor.run_masked

    def run_masked(self, f):
        taken.append("batched" if self.batched else "unrolled")
        return real_run(self, f)

    monkeypatch.setattr(tp_ell.EllSpGEMMExecutor, "run_masked", run_masked)
    real_pad = tp_masked.masked_spgemm_padded
    monkeypatch.setattr(tp_masked, "masked_spgemm_padded",
                        lambda *a, **k: taken.append("esc") or real_pad(*a, **k))
    return taken


@pytest.mark.parametrize("route", ["host", "unrolled", "batched", "esc", "esc-three-key"])
def test_masked_spgemm_routes(monkeypatch, route):
    """``masked_spgemm`` on each engine equals the JAX package's and scipy's."""
    n, d, kw = {"host": (600, 3.0, {}), "unrolled": (9000, 16.0, {}),
                "batched": (9000, 16.0, {}), "esc": (3000, 4.0, {"chunk_flops": 5000}),
                "esc-three-key": (1000, 3.0, {"chunk_flops": 4000})}[route]
    m = 1 << 22 if route == "esc-three-key" else n
    ja = jx.BCSR.random(n, n, d, seed=31)
    jb = jx.BCSR.random(n, m, d, seed=32)
    jf = jx.BCSR.random(n, m, 2 * d, seed=33)
    if route == "batched":  # as the JAX package's own test forces it
        for mod in (jx_ell, tp_ell):
            monkeypatch.setattr(mod, "prefer_batched", lambda a, b: True)
    taken = masked_routes(monkeypatch, route)
    ta, tb, tf = to_port(ja), to_port(jb), to_port(jf)
    c = tp.masked_spgemm(tf, ta, tb, device="cpu", **kw)
    assert taken and set(taken) == {route.split("-")[0]}
    assert_same(jx.masked_spgemm(jf, ja, jb, **kw), c)
    assert c.equals(masked_spgemm_oracle(tf, ta, tb))


def test_masked_spgemm_small_cases():
    """The JAX package's own cases: hand-checked, a full mask, an empty mask,
    a diagonal mask, a mask with duplicates."""
    a = tp.BCSR.from_dense(np.array([[1, 1, 0], [0, 1, 0], [1, 0, 1]]))
    f = tp.BCSR.from_dense(np.array([[1, 0, 1], [1, 1, 1], [0, 0, 1]]))
    c = tp.masked_spgemm(f, a, a, device="cpu")
    want = (a.to_dense().astype(int) @ a.to_dense().astype(int) > 0) & f.to_dense()
    assert np.array_equal(c.to_dense(), want)
    a = tp.BCSR.random(400, 400, 3.0, seed=1)
    full = tp.BCSR.from_dense(np.ones((400, 400)))
    assert tp.masked_spgemm(full, a, a, device="cpu").equals(spgemm_oracle(a, a))
    empty = tp.BCSR(np.zeros(401, np.int32), np.zeros(0, np.int32), (400, 400))
    assert tp.masked_spgemm(empty, a, a, device="cpu").nnz == 0
    eye = tp.BCSR.from_dense(np.eye(400))
    assert tp.masked_spgemm(eye, a, a, device="cpu").equals(
        masked_spgemm_oracle(eye, a, a))
    r, c_ = eye.to_coo()
    dup = tp.BCSR.from_coo(np.concatenate([r, r]), np.concatenate([c_, c_]), (400, 400))
    assert tp.masked_spgemm(dup, a, a, device="cpu").equals(
        masked_spgemm_oracle(eye, a, a))
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.masked_spgemm(tp.BCSR.random(399, 400, 1.0, seed=1), a, a, device="cpu")


def test_host_masked_spgemm_matches_jax():
    ja, jf = jx.BCSR.random(500, 500, 3.0, seed=2), jx.BCSR.random(500, 500, 6.0, seed=3)
    from binary_spgemm_tpu.ops.host import host_masked_spgemm

    c = tp.host_masked_spgemm(to_port(jf), to_port(ja), to_port(ja))
    assert_same(host_masked_spgemm(jf, ja, ja), c)
    assert tp_host.HOST_MAX_FLOPS == 2_000_000
