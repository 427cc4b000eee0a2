"""The port's fused product C = D OR ((F .*)? (A·B)) against the JAX
package's, on the CPU: the logical shifts at the int32 sentinels, the
three-way tagged join (packed and three-key, 1-D and batched), the streams
with D's pairs in place, the ``run_or`` outputs over their valid prefixes,
and ``spgemm_or`` on every route (host, batched packed and pair, unrolled
contiguous and dealt, chunked ESC), each bit-exact against the JAX package
and scipy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import ell as jx_ell
from binary_spgemm_tpu.ops import fused as jx_fused
from binary_spgemm_tpu.ops import host as jx_host

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import fused as tp_fused
from binary_spgemm_tpu_torch.ops import host as tp_host
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def assert_same(j, t):
    assert np.array_equal(j.indptr, t.indptr)
    assert np.array_equal(j.indices, t.indices)


def t_(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def j_(*xs):
    return [jnp.asarray(x) for x in xs]


def or_oracle(d, a, b, f=None):
    prod = a.to_scipy() @ b.to_scipy()
    if f is not None:
        prod = prod.multiply(f.to_scipy())
    c = (d.to_scipy() + prod).tocsr()
    c.eliminate_zeros()
    c.sort_indices()
    return tp.BCSR(c.indptr, c.indices, c.shape)


def test_logical_shift_at_the_sentinels():
    """The join reads the pair field with JAX's logical shift; torch's ``>>``
    is arithmetic, so a negative key (the -1 left of slot 0) would differ."""
    x = np.array([-1, -2, INT32_MIN, INT32_MIN + 1, INT32_MAX, INT32_MAX - 3, 0, 1, 5,
                  (1 << 30) + 7], np.int32)
    for s in range(1, 32):
        want = np.asarray(jax.lax.shift_right_logical(jnp.asarray(x), s))
        assert np.array_equal(tp_sp._shr_logical(torch.from_numpy(x), s).numpy(), want)
    assert tp_sp._shr_logical(torch.tensor([-1], dtype=torch.int32), 2).item() == (1 << 30) - 1


def join_case(n_rows, n_cols, L, seed, k=None):
    """Candidates, D pairs and mask pairs that overlap in every way (in D
    only, in F only, in both, in neither), duplicates, sentinel tails and
    one separator per row; with ``k``, ``[k, ·]`` stacks."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)

    def pairs(size):
        return (rng.integers(0, n_rows, lead + (size,)).astype(np.int32),
                rng.integers(0, n_cols, lead + (size,)).astype(np.int32))

    row, col = pairs(L)
    d_row, d_col = pairs(L // 2)
    f_row, f_col = pairs(L // 2)
    q = L // 8
    d_row[..., :q], d_col[..., :q] = row[..., :q], col[..., :q]  # product ∩ D
    f_row[..., :q], f_col[..., :q] = row[..., :q], col[..., :q]  # ... ∩ F too
    f_row[..., q : 2 * q], f_col[..., q : 2 * q] = row[..., q : 2 * q], col[..., q : 2 * q]
    d_row[..., q : q + 3], d_col[..., q : q + 3] = d_row[..., :3], d_col[..., :3]  # dup D
    row[..., 2 * q : 3 * q], col[..., 2 * q : 3 * q] = row[..., :q], col[..., :q]  # dups
    for r, c in ((row, col), (d_row, d_col), (f_row, f_col)):
        r[..., -q:], c[..., -q:] = n_rows, n_cols  # sentinel tails
    seps = min(n_rows, q)
    row[..., -2 * q : -2 * q + seps] = np.arange(seps)
    col[..., -2 * q : -2 * q + seps] = n_cols
    return row, col, d_row, d_col, f_row, f_col


# packed, and three-key; 37 rows at ~400 slots take the histogram, 6 the
# searchsorted; ((1 << 19) - 1, 1023) packs exactly at the int32 boundary,
# so the candidate sentinel key is INT32_MAX - 1
JOIN_CASES = [(37, 53), (6, 53), (37, 1 << 29), (6, 1 << 29), ((1 << 19) - 1, 1023)]


@pytest.mark.parametrize("n_rows,n_cols", JOIN_CASES)
def test_sort_compress_or_masked_matches_jax(n_rows, n_cols):
    arrays = join_case(n_rows, n_cols, 240, n_rows + 1)
    j = jx_fused._sort_compress_or_masked(*j_(*arrays), n_rows, n_cols)
    t = tp_fused._sort_compress_or_masked(*t_(*arrays), n_rows, n_cols)
    nnz = int(j[2])
    assert int(t[2]) == nnz and np.array_equal(np.asarray(j[0]), t[0].numpy())
    assert np.array_equal(np.asarray(j[1])[:nnz], t[1].numpy()[:nnz])
    row, col, d_row, d_col, f_row, f_col = (x.tolist() for x in arrays)
    fset = set(zip(f_row, f_col))
    want = ({p for p in zip(d_row, d_col) if p[0] < n_rows}
            | {p for p in zip(row, col) if p in fset and p[0] < n_rows})
    assert nnz == len(want)
    if n_rows == (1 << 19) - 1:
        key = (n_rows << 12) | (n_cols << 2) | 2
        assert key == INT32_MAX - 1 and tp_sp.packable(n_rows, 4 * n_cols + 3)


@pytest.mark.parametrize("n_rows,n_cols", JOIN_CASES)
def test_sort_compress_or_masked_seps_2d_matches_jax(n_rows, n_cols):
    arrays = join_case(n_rows, n_cols, 200, n_rows + 2, k=4)
    j_idx, j_nnz = (np.asarray(x) for x in jx_fused._sort_compress_or_masked_seps_2d(
        *j_(*arrays), n_rows, n_cols))
    outs = [tp_fused._sort_compress_or_masked_seps_2d(*t_(*arrays), n_rows, n_cols)]
    if tp_sp.packable(n_rows, 4 * n_cols + 3):
        key = (arrays[0] << int(n_cols).bit_length()) | arrays[1]
        j_k = jx_fused._sort_compress_or_masked_seps_2d_keys(
            *j_(key, *arrays[2:]), n_rows, n_cols)
        assert np.array_equal(np.asarray(j_k[1]), j_nnz)
        outs.append(tp_fused._sort_compress_or_masked_seps_2d_keys(
            *t_(key, *arrays[2:]), n_rows, n_cols))
    for t_idx, t_nnz in outs:
        assert t_idx.shape == j_idx.shape and np.array_equal(t_nnz.numpy(), j_nnz)
        for r in range(4):
            assert np.array_equal(t_idx[r, : j_nnz[r]].numpy(), j_idx[r, : j_nnz[r]])
    # the stacked rows with indptr (the unrolled join) equal the 1-D form
    ptr, idx, nnz = tp_fused._sort_compress_or_masked(*t_(*arrays), n_rows, n_cols)
    for r in range(4):
        one = jx_fused._sort_compress_or_masked(*j_(*(x[r] for x in arrays)), n_rows, n_cols)
        assert int(one[2]) == int(nnz[r]) and np.array_equal(np.asarray(one[0]), ptr[r].numpy())
        assert np.array_equal(np.asarray(one[1])[: int(nnz[r])], idx[r, : int(nnz[r])].numpy())


def padded(mat, extra, fill):
    idx = np.full(mat.nnz + extra, fill, np.int32)
    idx[: mat.nnz] = mat.indices
    return mat.indptr.astype(np.int32), idx, mat.nnz


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,m", [(300, 300), (1000, 1 << 20)])
def test_spgemm_or_padded_matches_jax(n, m, masked):
    a = jx.BCSR.random(n, min(n, m), 3.0, seed=n)
    b = jx.BCSR.random(a.n_cols, m, 2.0, seed=n + 1)
    d = jx.BCSR.random(n, m, 2.0, seed=n + 2)
    f = jx.BCSR.random(n, m, 5.0, seed=n + 3)
    flops_pad = tp_sp.pad_bucket(tp_sp.spgemm_flops(to_port(a), to_port(b)))
    dp, fp = padded(d, 7, 0), padded(f, 5, m)
    ap = (a.indptr.astype(np.int32), a.indices)
    bp = (b.indptr.astype(np.int32), b.indices)
    j = jx_fused.spgemm_or_padded(
        *j_(*dp[:2]), jnp.int32(dp[2]), *j_(*ap), jnp.int32(a.nnz), *j_(*bp),
        *(j_(*fp[:2]) if masked else ()), n_cols=m, flops_pad=flops_pad)
    t = tp_fused.spgemm_or_padded(
        *t_(*dp[:2]), dp[2], *t_(*ap), a.nnz, *t_(*bp),
        *(t_(*fp[:2]) if masked else ()), n_cols=m, flops_pad=flops_pad)
    nnz = int(j[2])
    assert int(t[2]) == nnz and np.array_equal(np.asarray(j[0]), t[0].numpy())
    assert np.array_equal(np.asarray(j[1])[:nnz], t[1].numpy()[:nnz])


def or_streams(mod, ex, d_st, *, to_np, masked_or):
    """Each dispatch group's stream as ``run_or`` sorts it, rebuilt with
    ``mod``'s own functions from ``ex``'s staged arrays and D: batched, the
    stream with D's pairs after the classes (the plain join) or without
    them (the masked join); unrolled, each chunk's pair stream, with D's
    pairs and the separators (plain) or neither (masked)."""
    tables = mod._unpack_tables(ex.tables_flat, ex.table_shapes)
    spans = tuple(p * w if s is None else p
                  for s, w, p in zip(ex.table_shapes, ex.widths, ex.pads))
    d_pad = d_st[1].shape[-1]
    out = []
    for row0 in ex._row0s():
        g = slice(row0, row0 + ex.group_size)
        er, ep = mod._unpack_entries(ex.er_all, ex.ep_all, row0, ex.group_size,
                                     ex.pads, spans)
        d = mod._staged_pairs_2d(d_st[0][g], d_st[1][g], ex.rows_pad, ex.n_cols)
        kw = dict(n_chunks=ex.group_size, rows_pad=ex.rows_pad, n_cols=ex.n_cols,
                  widths=ex.widths, pads=ex.pads)
        if ex.batched:
            if masked_or:
                packed = tp_sp.packable(ex.rows_pad, 4 * ex.n_cols + 3)
                sort_pad, extra = ex.sort_pad, ()
            else:
                packed = tp_sp.packable(ex.rows_pad, ex.n_cols)
                sort_pad = tp_sp.pad_bucket(ex.sort_pad + d_pad, div=32)
                extra = (d,)
            s = mod._assemble_stream_2d(
                tables, er, ep, ex.group_size, ex.rows_pad, ex.n_cols, ex.widths,
                ex.pads, sort_pad, extra=extra,
                shift=int(ex.n_cols).bit_length() if packed else None)
            out.append([to_np(x) for x in ((s,) if packed else s)])
        elif mod is tp_ell:
            if masked_or:
                s = mod._chunk_pair_streams(tables, er, ep, **kw,
                                            sort_pad=ex.sort_pad - ex.rows_pad, seps=False)
            else:
                s = mod._chunk_pair_streams(
                    tables, er, ep, **kw, extra=(d,),
                    sort_pad=tp_sp.pad_bucket(ex.sort_pad + d_pad, div=32))
            out.append([to_np(x) for x in s])
        else:  # the JAX package's per-chunk 1-D streams, composed as its kernels do
            sort_pad = (ex.sort_pad - ex.rows_pad if masked_or else
                        tp_sp.pad_bucket(ex.sort_pad + d_pad, div=32) - ex.rows_pad - d_pad)
            chunks = mod._chunk_pair_streams(tables, er, ep, **kw, sort_pad=sort_pad)
            rows, cols = [], []
            for k, (r, c) in enumerate(chunks):
                if not masked_or:
                    seps = jnp.arange(ex.rows_pad, dtype=jnp.int32)
                    r = jnp.concatenate([r, d[0][k], seps])
                    c = jnp.concatenate([c, d[1][k], jnp.full(ex.rows_pad, ex.n_cols,
                                                              jnp.int32)])
                rows.append(np.asarray(r))
                cols.append(np.asarray(c))
            out.append([np.stack(rows), np.stack(cols)])
    return out


def check_or_executor(ja, jb, jd, jf, **kw):
    """``run_or`` with and without a mask: the staged D, the streams, the
    outputs over their valid prefixes and the CSR equal the JAX package's,
    and the CSR scipy's."""
    ta, tb, td, tf = map(to_port, (ja, jb, jd, jf))
    jex = jx_ell.EllSpGEMMExecutor(ja, jb, **kw)
    tex = tp_ell.EllSpGEMMExecutor(ta, tb, device="cpu", **kw)
    assert (tex.n_chunks, tex.rows_pad, tex.sort_pad, tex.pads) == (
        jex.n_chunks, jex.rows_pad, jex.sort_pad, jex.pads)
    j_d, t_d = jex.stage_mask(jd), tex.stage_mask(td)
    assert all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(j_d, t_d))
    for masked_or in (False, True):
        js = or_streams(jx_ell, jex, j_d, to_np=np.asarray, masked_or=masked_or)
        ts = or_streams(tp_ell, tex, t_d, to_np=lambda x: x.numpy(), masked_or=masked_or)
        for jg, tg in zip(js, ts):
            assert all(np.array_equal(x, y) for x, y in zip(jg, tg))
        mask = (jf, tf) if masked_or else (None, None)
        j_out = [np.asarray(x) for x in jex.run_or(j_d, mask=mask[0])]
        t_res = tex.run_or(t_d, mask=mask[1])
        t_out = [x.numpy() for x in t_res]
        assert [x.shape for x in t_out] == [x.shape for x in j_out]
        assert np.array_equal(t_out[-1], j_out[-1])
        if len(t_out) == 3:
            assert np.array_equal(t_out[0], j_out[0])
        for c in range(len(t_out[-1])):
            n = t_out[-1][c]
            assert np.array_equal(t_out[-2][c, :n], j_out[-2][c, :n])
        c = tex.assemble(t_res)
        assert_same(jex.assemble(jex.run_or(jd, mask=mask[0])), c)
        assert c.equals(or_oracle(td, ta, tb, mask[1]))
    return tex


def test_batched_packed():
    n = 3000
    a, b = jx.BCSR.random(n, n, 3.0, seed=1), jx.BCSR.random(n, n, 2.0, seed=2)
    d, f = jx.BCSR.random(n, n, 1.5, seed=4), jx.BCSR.random(n, n, 4.0, seed=3)
    ex = check_or_executor(a, b, d, f, batched=True, deal_k=64, masked=True)
    assert tp_sp.packable(ex.rows_pad, 4 * n + 3)


@pytest.mark.parametrize("deal_k", [6, 1])
def test_batched_pair_branches(deal_k):
    """Wide columns: at 6 bins the masked key packs but the 2-bit-tagged one
    does not (the masked join takes its three-key branch while ``masked=True``
    plans guarantee only the first); at one bin not even the plain key packs
    (the plain join's int64 branch)."""
    n, m = 8000, 262145
    a, b = jx.BCSR.random(n, m, 3.0, seed=1), jx.BCSR.random(m, m, 0.2, seed=2)
    d, f = jx.BCSR.random(n, m, 1.0, seed=4), jx.BCSR.random(n, m, 2.0, seed=3)
    ex = check_or_executor(a, b, d, f, batched=True, deal_k=deal_k, masked=True)
    assert not tp_sp.packable(ex.rows_pad, 4 * m + 3)
    assert tp_sp.packable(ex.rows_pad, 2 * m + 1) == (deal_k == 6)
    assert tp_sp.packable(ex.rows_pad, m) == (deal_k == 6)


@pytest.mark.parametrize("kw", [{}, {"masked": True, "row_chunks": 1}, {"deal_k": 16}])
def test_unrolled(kw):
    n = 2500
    a, b = jx.BCSR.random(n, n, 3.0, seed=5), jx.BCSR.random(n, n, 2.5, seed=6)
    d, f = jx.BCSR.random(n, n, 1.0, seed=8), jx.BCSR.random(n, n, 5.0, seed=7)
    ex = check_or_executor(a, b, d, f, **kw)
    assert not ex.batched and (ex.row_sets is not None) == ("deal_k" in kw)


def test_unrolled_three_key():
    n, m = 600, 1 << 22
    a, b = jx.BCSR.random(n, 500, 3.0, seed=8), jx.BCSR.random(500, m, 2.0, seed=9)
    d, f = jx.BCSR.random(n, m, 1.0, seed=11), jx.BCSR.random(n, m, 3.0, seed=10)
    ex = check_or_executor(a, b, d, f, row_chunks=1)
    assert not tp_sp.packable(ex.rows_pad, m)


def or_route(monkeypatch):
    """Record which engine ``spgemm_or`` took."""
    taken = []
    real_host = tp_host.host_spgemm_or
    monkeypatch.setattr(tp_host, "host_spgemm_or",
                        lambda *a, **k: taken.append("host") or real_host(*a, **k))
    real_run = tp_ell.EllSpGEMMExecutor.run_or

    def run_or(self, d, mask=None):
        taken.append("batched" if self.batched else "unrolled")
        return real_run(self, d, mask=mask)

    monkeypatch.setattr(tp_ell.EllSpGEMMExecutor, "run_or", run_or)
    real_pad = tp_fused.spgemm_or_padded
    monkeypatch.setattr(tp_fused, "spgemm_or_padded",
                        lambda *a, **k: taken.append("esc") or real_pad(*a, **k))
    return taken


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("route", ["host", "unrolled", "batched", "esc", "esc-three-key"])
def test_spgemm_or_routes(monkeypatch, route, masked):
    """``spgemm_or`` on each engine equals the JAX package's and scipy's; the
    fused ELL budget and the host screen route as the JAX package's do."""
    n, d, kw = {"host": (200, 3.0, {}), "unrolled": (6000, 12.0, {}),
                "batched": (6000, 12.0, {}), "esc": (3000, 4.0, {"chunk_flops": 5000}),
                "esc-three-key": (1000, 3.0, {"chunk_flops": 4000})}[route]
    m = 1 << 22 if route == "esc-three-key" else n
    ja, jb = jx.BCSR.random(n, n, d, seed=41), jx.BCSR.random(n, m, d, seed=42)
    jd, jf = jx.BCSR.random(n, m, 1.0, seed=43), jx.BCSR.random(n, m, 2 * d, seed=44)
    if route == "batched":
        for mod in (jx_ell, tp_ell):
            monkeypatch.setattr(mod, "prefer_batched", lambda a, b: True)
    taken = or_route(monkeypatch)
    ta, tb, td, tf = map(to_port, (ja, jb, jd, jf))
    c = tp.spgemm_or(td, ta, tb, mask=tf if masked else None, device="cpu", **kw)
    assert taken and set(taken) == {route.split("-")[0]}
    assert_same(jx.spgemm_or(jd, ja, jb, mask=jf if masked else None, **kw), c)
    assert c.equals(or_oracle(td, ta, tb, tf if masked else None))


def test_spgemm_or_small_cases():
    """The JAX package's cases: an empty D, an empty product (D passes
    through, canonicalised), D unconditional under a mask, chunked equal to
    unchunked, shape errors."""
    a = tp.BCSR.random(300, 300, 5.0, seed=5)
    d = tp.BCSR.random(300, 300, 2.0, seed=6)
    f = tp.BCSR.random(300, 300, 6.0, seed=4)
    empty = tp.BCSR(np.zeros(301, np.int32), np.zeros(0, np.int32), (300, 300))
    assert tp.spgemm_or(empty, a, a, device="cpu").equals(or_oracle(empty, a, a))
    assert tp.spgemm_or(d, empty, a, device="cpu").equals(d.sum_duplicates())
    c = tp.spgemm_or(d, a, a, mask=f, device="cpu")
    assert c.equals(tp.spm_or(d, tp.masked_spgemm(f, a, a, device="cpu"), device="cpu"))
    assert c.equals(tp.spgemm_or(d, a, a, mask=f, chunk_flops=2048, device="cpu"))
    assert tp.spgemm_or(d, a, a, device="cpu").equals(
        tp.spgemm_or(d, a, a, chunk_flops=2048, device="cpu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.spgemm_or(tp.BCSR.random(301, 300, 1.0, seed=0), a, a, device="cpu")
    with pytest.raises(ValueError, match="mask shape"):
        tp.spgemm_or(d, a, a, mask=tp.BCSR.random(300, 299, 1.0, seed=0), device="cpu")


def test_host_spgemm_or_matches_jax():
    ja, jd = jx.BCSR.random(400, 400, 3.0, seed=2), jx.BCSR.random(400, 400, 2.0, seed=3)
    jf = jx.BCSR.random(400, 400, 6.0, seed=4)
    for mask in (None, jf):
        got = tp.host_spgemm_or(to_port(jd), to_port(ja), to_port(ja),
                                mask=None if mask is None else to_port(mask))
        assert_same(jx_host.host_spgemm_or(jd, ja, ja, mask=mask), got)
