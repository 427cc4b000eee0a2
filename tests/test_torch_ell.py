"""The port's batched sliced-ELL executor against the JAX package's, on the
shapes of ``tests/test_batched.py``: the same plan, the same staged arrays,
element-equal key streams, equal ``run()`` outputs over their valid prefixes,
and a CSR bit-exact against both the JAX executor and scipy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import ell as jx_ell

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops.spgemm import pad_bucket, packable
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

PLAN = ("n_chunks", "rows_pad", "widths", "pads", "inline", "sort_pad",
        "out_pad", "group_size", "n_groups")


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def assert_same(j, t):
    assert np.array_equal(j.indptr, t.indptr)
    assert np.array_equal(j.indices, t.indices)


def group_streams(mod, ex, tables_flat, er_all, ep_all, to_np):
    """Each dispatch group's assembled candidate stream, rebuilt with
    ``mod``'s own unpack/assemble functions from ``ex``'s staged arrays."""
    tables = mod._unpack_tables(tables_flat, ex.table_shapes)
    spans = tuple(p * w if s is None else p
                  for s, w, p in zip(ex.table_shapes, ex.widths, ex.pads))
    packed = packable(ex.rows_pad, ex.n_cols)
    shift = int(ex.n_cols).bit_length() if packed else None
    out = []
    for row0 in ex._row0s():
        er, ep = mod._unpack_entries(er_all, ep_all, row0, ex.group_size,
                                     ex.pads, spans)
        s = mod._assemble_stream_2d(
            tables, er, ep, ex.group_size, ex.rows_pad, ex.n_cols,
            ex.widths, ex.pads, ex.sort_pad, shift=shift,
        )
        out.append([to_np(x) for x in ((s,) if packed else s)])
    return out


def check_port_against_jax(ja, jb, **kw):
    ta, tb = to_port(ja), to_port(jb)
    jex = jx_ell.EllSpGEMMExecutor(ja, jb, batched=True, **kw)
    tex = tp_ell.EllSpGEMMExecutor(ta, tb, batched=True, device="cpu", **kw)
    assert jex.batched and tex.batched
    assert [getattr(tex, f) for f in PLAN] == [getattr(jex, f) for f in PLAN]
    assert tex.k_ranking == jex.k_ranking
    for name in ("tables_flat", "er_all", "ep_all"):
        got = getattr(tex, name)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(getattr(jex, name))), name

    j_streams = group_streams(
        jx_ell, jex, jex.tables_flat, jex.er_all, jex.ep_all, np.asarray
    )
    t_streams = group_streams(
        tp_ell, tex, tex.tables_flat, tex.er_all, tex.ep_all, lambda x: x.numpy()
    )
    for j_parts, t_parts in zip(j_streams, t_streams):
        for j, t in zip(j_parts, t_parts):
            assert t.shape == (tex.group_size, tex.sort_pad)
            assert np.array_equal(j, t)

    j_out, t_out = jex.run(), tex.run()
    j_idx, j_nnz = (np.asarray(x) for x in j_out)
    t_idx, t_nnz = (x.numpy() for x in t_out)
    assert t_idx.shape == j_idx.shape and np.array_equal(t_nnz, j_nnz)
    for c in range(len(t_nnz)):
        assert np.array_equal(t_idx[c, : t_nnz[c]], j_idx[c, : j_nnz[c]])

    c = tex.assemble(t_out)
    want = jex.assemble(j_out)
    assert np.array_equal(c.indptr, want.indptr)
    assert np.array_equal(c.indices, want.indices)
    assert c.equals(spgemm_oracle(ta, tb))
    return tex


@pytest.mark.parametrize(
    "n,d,seed", [(3000, 4.0, 1), (8000, 2.0, 2), (2000, 8.0, 3), (1000, 1.0, 4)]
)
def test_square_products(n, d, seed):
    a = jx.BCSR.random(n, n, d, seed=seed)
    check_port_against_jax(a, a)


def test_many_bins_take_the_vectorised_assembly():
    a = jx.BCSR.random(20000, 20000, 3.0, seed=3)
    ex = check_port_against_jax(a, a, deal_k=512)
    assert ex.n_chunks == 512  # >= 256 bins: _assemble_seps_batch


def test_rectangular():
    a = jx.BCSR.random(4000, 1500, 3.0, seed=6)
    b = jx.BCSR.random(1500, 2500, 2.0, seed=7)
    check_port_against_jax(a, b)


@pytest.mark.parametrize("deal_k", [4, 1])
def test_wide_columns(deal_k):
    # the operands of test_batched_op_family_unpacked; one bin makes the
    # plain product's keys unpackable too, so the int64 pair form runs
    n, m = 8000, 262145
    a = jx.BCSR.random(n, m, 3.0, seed=1)
    b = jx.BCSR.random(m, m, 0.2, seed=2)
    ex = check_port_against_jax(a, b, deal_k=deal_k)
    assert packable(ex.rows_pad, m) == (deal_k == 4)


def test_inline_narrow_classes():
    rng = np.random.default_rng(33)
    n = 3000
    rows, cols = [], []
    for r in range(n):
        w = int(rng.choice([1, 1, 2, 2, 3, 8]))
        cs = rng.choice(n, size=w, replace=False)
        rows.extend([r] * w)
        cols.extend(cs.tolist())
    b = jx.BCSR.from_coo(np.array(rows), np.array(cols), (n, n))
    a = jx.BCSR.random(n, n, 2.0, seed=34)
    ex = check_port_against_jax(a, b)
    assert any(inl and w <= 2 for inl, w in zip(ex.inline, ex.widths))
    assert not any(inl and w > 2 for inl, w in zip(ex.inline, ex.widths))


def test_several_dispatch_groups():
    a = jx.BCSR.random(1 << 16, 1 << 16, 2.0, seed=31)
    ex = check_port_against_jax(a, a, batched_slots_cap=jx_ell.BATCHED_MAX_SLOTS)
    assert ex.total_slots <= tp_ell.SMALL_PLAN_SLOTS and ex.n_groups >= 2


def test_one_row():
    a = jx.BCSR.random(1, 1, 16.0, seed=5)
    check_port_against_jax(a, a)


def test_degenerate_input_raises():
    """No flops in any bin: ``_batched_deal_plan`` returns None and both
    packages drop to the unrolled plan, which serves the (empty) product;
    ``batched=False`` is the unrolled plan itself.  Nothing raises."""
    empty = jx.BCSR(np.zeros(101, np.int32), np.zeros(0, np.int32), (100, 100))
    jex = jx_ell.EllSpGEMMExecutor(empty, empty, batched=True)
    tex = tp_ell.EllSpGEMMExecutor(
        to_port(empty), to_port(empty), batched=True, device="cpu"
    )
    assert not jex.batched and not tex.batched
    assert (tex.n_chunks, tex.rows_pad, tex.sort_pad, tex.chunks) == (
        jex.n_chunks, jex.rows_pad, jex.sort_pad, jex.chunks
    )
    c = tex.assemble(tex.run())
    assert c.nnz == 0 and c.equals(spgemm_oracle(to_port(empty), to_port(empty)))
    ja = jx.BCSR.random(50, 50, 2.0, seed=1)
    a = to_port(ja)
    ex = tp_ell.EllSpGEMMExecutor(a, a, device="cpu")  # batched=False
    jx_ex = jx_ell.EllSpGEMMExecutor(ja, ja)
    assert not ex.batched and ex.chunks == jx_ex.chunks
    c = ex.assemble(ex.run())
    assert np.array_equal(c.indices, jx_ex.assemble(jx_ex.run()).indices)
    assert c.equals(spgemm_oracle(a, a))


def test_skew_guard_raises_before_staging():
    a = tp.BCSR.random(3000, 3000, 4.0, seed=1)
    with pytest.raises(OverflowError, match="auto-route cap"):
        tp_ell.EllSpGEMMExecutor(
            a, a, batched=True, batched_slots_cap=1, device="cpu"
        )


def test_ellb_matches_jax():
    jb = jx.BCSR.random(300, 300, 4.0, seed=12)
    tb = to_port(jb)
    for gw in (None, (4, 16, 64)):
        j, t = jx_ell.EllB.build(jb, gw), tp_ell.EllB.build(tb, gw)
        assert t.widths == j.widths
        assert np.array_equal(t.class_of_row, j.class_of_row)
        assert np.array_equal(t.pos_in_class, j.pos_in_class)
        assert all(np.array_equal(x, y) for x, y in zip(t.tables, j.tables))
        je, te = jx_ell._build_class_entries(jb, j), tp_ell._build_class_entries(tb, t)
        for jl, tl in zip(je, te):
            assert all(np.array_equal(x, y) for x, y in zip(jl, tl))
    with pytest.raises(ValueError, match="do not cover"):
        tp_ell.EllB.build(tb, (2,))
    assert [tp_ell.width_bucket(w) for w in range(1, 200)] == [
        jx_ell.width_bucket(w) for w in range(1, 200)
    ]


def test_expand_class_pair_and_key_forms_agree():
    rng = np.random.default_rng(2)
    k, pad, w, rows_pad, n_cols = 5, 12, 3, 8, 100
    table = rng.integers(0, n_cols + 1, (20, w)).astype(np.int32)
    er = rng.integers(0, rows_pad + 1, (k, pad)).astype(np.int32)
    ep = rng.integers(0, 20, (k, pad)).astype(np.int32)
    shift = int(n_cols).bit_length()
    args = (rows_pad, n_cols, w)
    j_key = np.asarray(jx_ell._expand_class_2d(
        jnp.asarray(table), jnp.asarray(er), jnp.asarray(ep), *args, shift=shift))
    t_key = tp_ell._expand_class_2d(
        torch.from_numpy(table), torch.from_numpy(er), torch.from_numpy(ep),
        *args, shift=shift).numpy()
    assert np.array_equal(j_key, t_key)
    r, c = tp_ell._expand_class_2d(
        torch.from_numpy(table), torch.from_numpy(er), torch.from_numpy(ep), *args)
    assert np.array_equal(((r << shift) | c).numpy(), t_key)


@pytest.mark.parametrize("case", ["square", "many-bins", "groups", "wide", "one-row"])
def test_run_padded_matches_jax(case):
    """The one-sort step: the sorted packed-key streams with their INT32_MAX
    holes element-equal to the JAX package's over the whole padded length,
    the valid counts equal, and ``assemble_padded`` equal to the JAX
    package's, to ``assemble(run())`` and to scipy."""
    n, d, seed, kw = {
        "square": (3000, 4.0, 1, {}),
        "many-bins": (20000, 3.0, 3, {"deal_k": 512}),
        "groups": (1 << 16, 2.0, 31, {"batched_slots_cap": jx_ell.BATCHED_MAX_SLOTS}),
        "wide": (8000, 3.0, 1, {"deal_k": 4}),
        "one-row": (1, 16.0, 5, {}),
    }[case]
    m = 262145 if case == "wide" else n  # the operands of test_wide_columns
    ja = jx.BCSR.random(n, m, d, seed=seed)
    jb = jx.BCSR.random(m, m, 0.2, seed=2) if case == "wide" else ja
    ta, tb = to_port(ja), to_port(jb)
    jex = jx_ell.EllSpGEMMExecutor(ja, jb, batched=True, **kw)
    tex = tp_ell.EllSpGEMMExecutor(ta, tb, batched=True, device="cpu", **kw)
    assert [getattr(tex, f) for f in PLAN] == [getattr(jex, f) for f in PLAN]
    j_keys, j_nnz = (np.asarray(x) for x in jex.run_padded())
    t_out = tex.run_padded()
    t_keys, t_nnz = (x.numpy() for x in t_out)
    assert t_keys.shape == (tex.n_groups * tex.group_size, tex.sort_pad)
    assert np.array_equal(t_keys, j_keys) and np.array_equal(t_nnz, j_nnz)
    assert ((t_keys != (1 << 31) - 1).sum(1) == t_nnz).all()
    c = tex.assemble_padded(t_out)
    assert_same(jex.assemble_padded(jex.run_padded()), c)
    assert c.equals(tex.assemble(tex.run()))
    assert c.equals(spgemm_oracle(ta, tb))


def test_run_padded_needs_a_batched_plan():
    a = tp.BCSR.random(500, 500, 2.0, seed=1)
    ex = tp_ell.EllSpGEMMExecutor(a, a, device="cpu")
    with pytest.raises(ValueError, match="batched executor"):
        ex.run_padded()


def test_assemble_stream_with_a_d_operand_matches_jax():
    """``_assemble_stream_2d``'s extra pair block (a fused-OR D) lands after
    the class expansions and before the separators, as in the JAX package,
    in the packed and the pair form."""
    n = 2000
    ja, jd = jx.BCSR.random(n, n, 3.0, seed=4), jx.BCSR.random(n, n, 2.0, seed=5)
    jex = jx_ell.EllSpGEMMExecutor(ja, ja, batched=True, deal_k=16)
    tex = tp_ell.EllSpGEMMExecutor(to_port(ja), to_port(ja), batched=True, deal_k=16,
                                   device="cpu")
    j_d, t_d = jex.stage_mask(jd), tex.stage_mask(to_port(jd))
    sort_pad = pad_bucket(tex.sort_pad + t_d[1].shape[1], div=32)
    for mod, ex, st, to_np in ((jx_ell, jex, j_d, np.asarray),
                               (tp_ell, tex, t_d, lambda x: x.numpy())):
        tables = mod._unpack_tables(ex.tables_flat, ex.table_shapes)
        spans = tuple(p * w if s is None else p
                      for s, w, p in zip(ex.table_shapes, ex.widths, ex.pads))
        er, ep = mod._unpack_entries(ex.er_all, ex.ep_all, 0, ex.group_size, ex.pads, spans)
        pairs = mod._staged_pairs_2d(st[0][: ex.group_size], st[1][: ex.group_size],
                                     ex.rows_pad, ex.n_cols)
        args = (tables, er, ep, ex.group_size, ex.rows_pad, ex.n_cols, ex.widths,
                ex.pads, sort_pad)
        key = mod._assemble_stream_2d(*args, extra=(pairs,),
                                      shift=int(ex.n_cols).bit_length())
        row, col = mod._assemble_stream_2d(*args, extra=(pairs,))
        if mod is jx_ell:
            want = [to_np(x) for x in (key, row, col)]
        else:
            got = [to_np(x) for x in (key, row, col)]
    assert all(np.array_equal(x, y) for x, y in zip(want, got))
