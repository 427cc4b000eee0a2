"""The port's unrolled sliced-ELL executor (``EllSpGEMMExecutor`` with
``batched=False``) against the JAX package's, on the shapes of
``tests/test_ell.py``: the same plan (contiguous ``chunks``/``bounds`` or
dealt ``row_sets``), the same staged arrays, element-equal per-chunk pair
streams, equal ``run()`` outputs over their valid prefixes, and a CSR
bit-exact against the JAX executor and scipy through ``assemble()`` and
``run_assemble_streaming()``.  Also each ``row_chunks`` form, ``deal_k``,
``merge_widths`` on the batched plan, the 1-D compaction step and the
contiguous chunking."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import ell as jx_ell
from binary_spgemm_tpu.ops import spgemm as jx_sp

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

PLAN = ("batched", "n_chunks", "rows_pad", "widths", "pads", "inline",
        "table_shapes", "sort_pad", "out_pad", "total_slots", "resident_slots",
        "group_size", "n_groups")


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def same_plan(jex, tex):
    assert [getattr(tex, f) for f in PLAN] == [getattr(jex, f) for f in PLAN]
    assert tex.chunks == jex.chunks
    if jex.bounds is None:
        assert tex.bounds is None
    else:
        assert np.array_equal(tex.bounds, jex.bounds)
    if jex.row_sets is None:
        assert tex.row_sets is None
    else:
        assert len(tex.row_sets) == len(jex.row_sets)
        assert all(np.array_equal(t, j) for t, j in zip(tex.row_sets, jex.row_sets))
    for name in ("tables_flat", "er_all", "ep_all"):
        got = getattr(tex, name)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(getattr(jex, name))), name


def group_pair_streams(mod, ex, to_np):
    """Every real chunk's pair stream, rebuilt with ``mod``'s own
    ``_chunk_pair_streams`` from ``ex``'s staged arrays: the JAX package's
    without separators, the port's with them in the last ``rows_pad``
    columns."""
    tables = mod._unpack_tables(ex.tables_flat, ex.table_shapes)
    spans = tuple(p * w if s is None else p
                  for s, w, p in zip(ex.table_shapes, ex.widths, ex.pads))
    out = []
    for row0 in ex._row0s():
        er, ep = mod._unpack_entries(ex.er_all, ex.ep_all, row0, ex.group_size,
                                     ex.pads, spans)
        seps = ex.rows_pad if mod is jx_ell else 0
        streams = mod._chunk_pair_streams(
            tables, er, ep, n_chunks=ex.group_size, rows_pad=ex.rows_pad,
            n_cols=ex.n_cols, widths=ex.widths, pads=ex.pads,
            sort_pad=ex.sort_pad - seps,
        )
        if mod is tp_ell:  # stacked [g, L]: row i is chunk i
            r, c = streams
            out += [(to_np(r[i]), to_np(c[i])) for i in range(ex.group_size)]
        else:
            out += [(to_np(r), to_np(c)) for r, c in streams]
    return out[: ex.n_chunks]


def check_port_against_jax(ja, jb, streams=True, **kw):
    ta, tb = to_port(ja), to_port(jb)
    jex = jx_ell.EllSpGEMMExecutor(ja, jb, **kw)
    tex = tp_ell.EllSpGEMMExecutor(ta, tb, device="cpu", **kw)
    assert not tex.batched
    same_plan(jex, tex)
    if streams:
        j_s = group_pair_streams(jx_ell, jex, np.asarray)
        t_s = group_pair_streams(tp_ell, tex, lambda x: x.numpy())
        body = tex.sort_pad - tex.rows_pad
        seps = np.arange(tex.rows_pad)
        for (jr, jc), (tr, tc) in zip(j_s, t_s):
            assert np.array_equal(jr, tr[:body]) and np.array_equal(jc, tc[:body])
            assert np.array_equal(tr[body:], seps) and np.all(tc[body:] == tex.n_cols)

    j_out, t_out = jex.run(), tex.run()
    j_idx, j_nnz = (np.asarray(x) for x in j_out)
    t_idx, t_nnz = (x.numpy() for x in t_out)
    assert t_idx.shape == j_idx.shape and np.array_equal(t_nnz, j_nnz)
    for c in range(tex.n_chunks):
        assert np.array_equal(t_idx[c, : t_nnz[c]], j_idx[c, : j_nnz[c]])

    ref = spgemm_oracle(ta, tb)
    c = tex.assemble(t_out)
    want = jex.assemble(j_out)
    assert np.array_equal(c.indptr, want.indptr)
    assert np.array_equal(c.indices, want.indices)
    assert c.equals(ref)
    return tex, jex, ref


@pytest.mark.parametrize("seed,n,d", [(0, 300, 3.0), (1, 500, 8.0), (2, 257, 1.0)])
def test_ell_matches_jax_and_oracle(seed, n, d):
    a = jx.BCSR.random(n, n, d, seed=seed)
    tex, _, ref = check_port_against_jax(a, a)
    assert tp.ell_spgemm(to_port(a), to_port(a), device="cpu").equals(ref)


def test_rectangular():
    a = jx.BCSR.random(123, 301, 3.0, seed=11)
    b = jx.BCSR.random(301, 203, 2.0, seed=12)
    check_port_against_jax(a, b)


def test_rmat_powerlaw():
    a = jx.BCSR.rmat(9, 6.0, seed=5)
    check_port_against_jax(a, a)


def test_empty_and_degenerate():
    z = jx.BCSR(np.zeros(11, np.int32), np.zeros(0, np.int32), (10, 10))
    tex, _, _ = check_port_against_jax(z, z)
    assert tex.widths == () and tex.n_chunks == 1
    # B with empty rows referenced by A
    a = jx.BCSR.from_coo(np.array([0, 1, 2]), np.array([5, 5, 5]), (3, 6))
    b = jx.BCSR.from_coo(np.array([0]), np.array([1]), (6, 4))  # row 5 empty
    check_port_against_jax(a, b)


@pytest.mark.parametrize(
    "row_chunks,dealt", [("auto", False), ("contig", False), ("deal", True),
                         (1, False), (5, False)],
)
def test_row_chunks_forms(row_chunks, dealt):
    a = jx.BCSR.random(500, 500, 6.0, seed=31)
    tex, _, _ = check_port_against_jax(a, a, row_chunks=row_chunks)
    assert (tex.row_sets is not None) == dealt
    if row_chunks == 1:
        assert tex.n_chunks == 1 and tex.chunks == [(0, 500)]


def test_deal_k():
    a = jx.BCSR.random(500, 500, 6.0, seed=31)
    tex, _, _ = check_port_against_jax(a, a, deal_k=7)
    assert tex.n_chunks == 7 and tex.row_sets is not None


def test_super_chunked_dispatch(monkeypatch):
    a = jx.BCSR.random(500, 500, 6.0, seed=31)
    ref_ex = tp_ell.EllSpGEMMExecutor(to_port(a), to_port(a), row_chunks=5, device="cpu")
    for mod in (jx_ell, tp_ell):
        monkeypatch.setattr(mod, "DISPATCH_SLOT_BUDGET", ref_ex.sort_pad * 4)
    tex, _, _ = check_port_against_jax(a, a, row_chunks=5)
    # 6 chunks in 2 groups of 4: the last group ends in 2 dummy chunks
    assert (tex.n_chunks, tex.n_groups, tex.group_size) == (6, 2, 4)


def test_streaming_assembly(monkeypatch):
    a = jx.BCSR.random(500, 500, 6.0, seed=41)
    ref_ex = tp_ell.EllSpGEMMExecutor(to_port(a), to_port(a), row_chunks=5, device="cpu")
    for mod in (jx_ell, tp_ell):
        monkeypatch.setattr(mod, "DISPATCH_SLOT_BUDGET", ref_ex.sort_pad * 2)
    tex, jex, ref = check_port_against_jax(a, a, row_chunks=5, streams=False)
    c = tex.run_assemble_streaming()
    assert c.equals(ref)
    want = jex.run_assemble_streaming()
    assert np.array_equal(c.indptr, want.indptr)
    assert np.array_equal(c.indices, want.indices)


def test_dealt_plan_matches_jax_and_oracle():
    # power-law rows: the dealt plan's home turf
    a = jx.BCSR.rmat(10, 5.0, seed=61)
    tex, _, ref = check_port_against_jax(a, a, row_chunks="deal", streams=False)
    assert tex.row_sets is not None and tex.chunks is None
    allrows = np.sort(np.concatenate(tex.row_sets))
    assert np.array_equal(allrows, np.arange(a.n_rows))
    assert tex.run_assemble_streaming().equals(ref)
    exc = tp_ell.EllSpGEMMExecutor(to_port(a), to_port(a), row_chunks="contig", device="cpu")
    assert exc.row_sets is None and exc.assemble(exc.run()).equals(ref)


def test_dealt_super_chunked(monkeypatch):
    a = jx.BCSR.rmat(9, 5.0, seed=64)
    ref_ex = tp_ell.EllSpGEMMExecutor(to_port(a), to_port(a), row_chunks="deal", device="cpu")
    for mod in (jx_ell, tp_ell):
        monkeypatch.setattr(
            mod, "DISPATCH_SLOT_BUDGET", ref_ex.sort_pad * ref_ex.n_chunks // 3
        )
    tex, _, _ = check_port_against_jax(a, a, row_chunks="deal", streams=False)
    assert tex.n_groups >= 2 and tex.row_sets is not None


def test_many_dealt_chunks_take_the_vectorised_assembly():
    """256 or more chunks assemble in one vectorised pass, dealt or not."""
    a = jx.BCSR.random(2000, 2000, 2.0, seed=8)
    for kw in ({"deal_k": 300}, {"row_chunks": 300}):
        ta = to_port(a)
        tex = tp_ell.EllSpGEMMExecutor(ta, ta, device="cpu", **kw)
        assert tex.n_chunks >= 256
        out = tex.run()
        nnz = out[1].numpy()
        parts = [
            tp_sp.split_seps(out[0][i].numpy(), int(nnz[i]), tex.rows_pad, tex.n_cols)
            for i in range(tex.n_chunks)
        ]
        c = tex.assemble(out)
        assert c.equals(tex._assemble_parts(parts))
        assert c.equals(spgemm_oracle(ta, ta))


@pytest.mark.parametrize("merge_widths", [(8, 16, 32), (4, 64)])
def test_merge_widths_on_the_batched_plan(merge_widths):
    ja = jx.BCSR.random(3000, 3000, 4.0, seed=1)
    ta = to_port(ja)
    jex = jx_ell.EllSpGEMMExecutor(ja, ja, batched=True, merge_widths=merge_widths)
    tex = tp_ell.EllSpGEMMExecutor(
        ta, ta, batched=True, merge_widths=merge_widths, device="cpu"
    )
    assert tex.batched and jex.batched
    fine = tp_ell.EllB.build(ta).widths
    assert len(tex.widths) <= len(merge_widths) < len(fine)
    same_plan(jex, tex)
    assert tex.k_ranking == jex.k_ranking
    c = tex.assemble(tex.run())
    assert np.array_equal(c.indices, jex.assemble(jex.run()).indices)
    assert c.equals(spgemm_oracle(ta, ta))


def test_merge_widths_must_cover_the_widest_class():
    a = tp.BCSR.random(300, 300, 4.0, seed=1)
    with pytest.raises(ValueError, match="do not cover"):
        tp_ell.EllSpGEMMExecutor(a, a, batched=True, merge_widths=(2,), device="cpu")


@pytest.mark.parametrize("budget,max_rows", [(50, None), (200, 7), (1, None), (10**9, 3)])
def test_chunk_rows_and_bounds_match_jax(budget, max_rows):
    rng = np.random.default_rng(budget)
    rf = rng.integers(0, 40, 300).astype(np.int64)
    rf[10:30] = 0  # a zero-flop run
    rf[100] = 5000  # one row past any budget
    assert tp_sp._chunk_rows(rf, budget, max_rows) == jx_sp._chunk_rows(rf, budget, max_rows)
    if max_rows is not None:
        assert tp_ell._chunk_bounds(rf, budget, max_rows) == jx_ell._chunk_bounds(
            rf, budget, max_rows
        )
    assert tp_sp._chunk_rows(np.zeros(0, np.int64), 5) == [(0, 0)]


@pytest.mark.parametrize("n_cols", [100, 1 << 28])
def test_1d_compaction_rows_match_jax(n_cols):
    """Each row of the port's 2-D step on a group equals the JAX package's
    1-D ``sort_compress_seps`` on that chunk (packed keys for n_cols = 100,
    where ``sort_compress_seps_keys`` on the packed row agrees too; the pair
    form for 2^28, where the pairs do not pack)."""
    rng = np.random.default_rng(n_cols % 97)
    g, L, rows_pad = 4, 300, 16
    row = rng.integers(0, rows_pad + 1, (g, L)).astype(np.int32)
    col = rng.integers(0, 60, (g, L)).astype(np.int32)
    col[row == rows_pad] = n_cols
    row[:, -rows_pad:] = np.arange(rows_pad)  # separators
    col[:, -rows_pad:] = n_cols
    idx, nnz = tp_sp.sort_compress_seps_2d(
        torch.from_numpy(row), torch.from_numpy(col), rows_pad, n_cols
    )
    for i in range(g):
        j_idx, j_nnz = jx_sp.sort_compress_seps(
            jnp.asarray(row[i]), jnp.asarray(col[i]), rows_pad, n_cols
        )
        assert int(nnz[i]) == int(j_nnz)
        assert np.array_equal(idx[i, : int(nnz[i])].numpy(), np.asarray(j_idx)[: int(j_nnz)])
        if n_cols == 100:
            shift = int(n_cols).bit_length()
            key = (row[i] << shift) | col[i]
            jk_idx, jk_nnz = jx_sp.sort_compress_seps_keys(jnp.asarray(key), rows_pad, n_cols)
            assert int(jk_nnz) == int(nnz[i])
            assert np.array_equal(np.asarray(jk_idx), idx[i].numpy())


def test_overflow_routes_to_the_esc_item(monkeypatch):
    """Where every ELL plan overflows int32 both packages take the chunked
    ESC engine (the port raised before it was ported)."""
    ja = jx.BCSR.random(3000, 3000, 30.0, seed=1)  # past HOST_MAX_FLOPS
    a = to_port(ja)

    def overflow(*args, **kwargs):
        raise OverflowError("ELL chunk expansion exceeds int32")

    for mod in (tp_ell, jx_ell):
        monkeypatch.setattr(mod, "EllSpGEMMExecutor", overflow)
    ex = tp.auto_executor(a, a, device="cpu")
    jex = jx_ell.auto_executor(ja, ja)
    assert isinstance(ex, tp_sp.SpGEMMExecutor) and isinstance(jex, jx_sp.SpGEMMExecutor)
    assert (ex.chunks, ex.flops_pad) == (jex.chunks, jex.flops_pad)
    ref = spgemm_oracle(a, a)
    c = ex.assemble(ex.run())
    assert c.equals(ref)
    tp_ell._EXEC_CACHE.clear()
    jx_ell._EXEC_CACHE.clear()
    c1 = tp.spgemm(a, a, device="cpu")
    assert c1.equals(ref)
    j1 = jx.spgemm(ja, ja)
    assert np.array_equal(j1.indptr, c1.indptr) and np.array_equal(j1.indices, c1.indices)
