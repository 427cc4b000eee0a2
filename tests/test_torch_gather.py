"""The class-table gathers P3 (``class_gather``) and P4
(``class_gather_keys``) on the CPU: their plain versions against the JAX
package's ``_expand_class`` / ``_expand_class_2d`` and against the check of
the Pallas prototype they replace (``benchmarks/pallas_gather.py``), the
port's expansion of inlined and gathered classes, writes into a column span
of a wider stream, and the wrappers' contract (no launch and no count on a
CPU tensor, raise on what the kernels do not take)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_spgemm_tpu.ops import ell as jx_ell

from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import gather


def class_case(w, seed, g=5, pad=12, nc=20, rows_pad=8, n_cols=100):
    """A class table with sentinel padding, row ids with sentinel and
    out-of-range rows, and positions with out-of-range and negative ones."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n_cols, (nc, w)).astype(np.int32)
    lens = rng.integers(1, w + 1, nc)
    table[np.arange(w)[None, :] >= lens[:, None]] = n_cols  # sentinel tails
    rows = rng.integers(0, rows_pad, (g, pad)).astype(np.int32)
    rows[:, -2:] = rows_pad  # staged padding rows
    rows[0, 0] = rows_pad + 3  # past the sentinel row
    pos = rng.integers(0, nc, (g, pad)).astype(np.int32)
    pos[:, -2:] = 0  # staged padding positions
    pos[1, :4] = [nc, nc + 7, -1, -nc - 2]  # clamped as JAX's indexing clamps
    return table, rows, pos, rows_pad, n_cols


def jax_expand(table, rows, pos, rows_pad, n_cols, w, shift=None):
    out = jx_ell._expand_class_2d(
        None if table is None else jnp.asarray(table), jnp.asarray(rows),
        jnp.asarray(pos), rows_pad, n_cols, w, shift=shift,
    )
    return np.asarray(out) if shift is not None else tuple(np.asarray(x) for x in out)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


WIDTHS = [1, 2, 3, 16, 40, 200]


@pytest.mark.parametrize("w", WIDTHS)
def test_p3_plain_matches_jax_expand_class_2d(w):
    table, rows, pos, rows_pad, n_cols = class_case(w, w)
    want_r, want_c = jax_expand(table, rows, pos, rows_pad, n_cols, w)
    for fn in (gather.class_gather_plain, gather.class_gather):
        r, c = fn(t(table), t(pos), t(rows), rows_pad, n_cols)
        assert r.dtype == c.dtype == torch.int32
        assert np.array_equal(r.numpy(), want_r)
        assert np.array_equal(c.numpy(), want_c)
    # sentinel rows and sentinel columns come out as (rows_pad, n_cols)
    bad = (rows[..., None] >= rows_pad).repeat(w, axis=2).reshape(rows.shape[0], -1)
    assert np.all(want_r[bad] == rows_pad) and np.all(want_c[bad] == n_cols)


@pytest.mark.parametrize("w", WIDTHS)
def test_p4_plain_matches_jax_expand_class_2d_keys(w):
    table, rows, pos, rows_pad, n_cols = class_case(w, 100 + w)
    shift = int(n_cols).bit_length()
    want = jax_expand(table, rows, pos, rows_pad, n_cols, w, shift=shift)
    for fn in (gather.class_gather_keys_plain, gather.class_gather_keys):
        got = fn(t(table), t(pos), t(rows), rows_pad, n_cols, shift)
        assert np.array_equal(got.numpy(), want)
    assert np.sum(want == (rows_pad << shift) | n_cols) > 0


@pytest.mark.parametrize("w", [1, 3, 16])
def test_p3_rows_match_jax_expand_class(w):
    """Each row of P3's output is the JAX package's 1-D expansion of that
    chunk (the unrolled engine's ``_expand_class``)."""
    table, rows, pos, rows_pad, n_cols = class_case(w, 7 * w)
    r, c = gather.class_gather(t(table), t(pos), t(rows), rows_pad, n_cols)
    for i in range(rows.shape[0]):
        jr, jc = jx_ell._expand_class(
            jnp.asarray(table), jnp.asarray(rows[i]), jnp.asarray(pos[i]),
            rows_pad, n_cols, w,
        )
        assert np.array_equal(r[i].numpy(), np.asarray(jr))
        assert np.array_equal(c[i].numpy(), np.asarray(jc))


def test_prototype_check():
    """The Pallas prototype's own check (``pallas_gather.py:141-143``), at a
    small size: with every slot valid, P3's columns are ``table[pos]`` and P4
    is ``(rows << shift) | table[pos]``."""
    rng = np.random.default_rng(0)
    nt, w, e, shift = 1 << 10, 16, 1 << 12, 17
    table = rng.integers(0, 1 << 16, (nt, w), dtype=np.int32)
    pos = rng.integers(0, nt, (e,), dtype=np.int32)
    rows = rng.integers(0, 8192, (e,), dtype=np.int32)
    ref = table[pos]
    exp = (rows[:, None] << shift) | ref
    _, cols = gather.class_gather(t(table), t(pos[None]), t(rows[None]), 8192, 1 << 16)
    assert np.array_equal(cols.numpy().reshape(e, w), ref)
    keys = gather.class_gather_keys(
        t(table), t(pos[None]), t(rows[None]), 8192, 1 << 16, shift
    )
    assert np.array_equal(keys.numpy().reshape(e, w), exp)


@pytest.mark.parametrize("shift", [None, 7])
@pytest.mark.parametrize("w", [1, 2, 5])
def test_inlined_and_gathered_classes_agree_with_jax(w, shift):
    """The port's ``_expand_class_2d`` on an inlined class (B's row values
    staged in place of positions) and on the same class gathered from its
    table: both equal to the JAX package's."""
    table, rows, pos, rows_pad, n_cols = class_case(w, 31 + w)
    pos = np.clip(pos, 0, table.shape[0] - 1)
    inlined = table[pos].reshape(pos.shape[0], -1)
    want = jax_expand(None, rows, inlined, rows_pad, n_cols, w, shift=shift)
    for tbl, ep in ((None, inlined), (table, pos)):
        got = tp_ell._expand_class_2d(
            None if tbl is None else t(tbl), t(rows), t(ep), rows_pad, n_cols,
            w, shift=shift,
        )
        got = (got,) if shift is not None else got
        want_t = (want,) if shift is not None else want
        for g_, w_ in zip(got, want_t):
            assert np.array_equal(g_.numpy(), w_)


@pytest.mark.parametrize("keys", [False, True])
def test_writes_into_a_column_span(keys):
    """Given ``out``, a wrapper fills columns ``col0 : col0 + pad*w`` of the
    wider stream and leaves the rest as it was; inputs may be column slices
    of wider staged arrays."""
    w = 3
    table, rows, pos, rows_pad, n_cols = class_case(w, 55)
    g, pad = rows.shape
    wide_r = np.full((g, pad + 9), 77, np.int32)
    wide_p = np.full((g, pad + 9), 5, np.int32)
    wide_r[:, 4 : 4 + pad], wide_p[:, 4 : 4 + pad] = rows, pos
    r_view, p_view = t(wide_r)[:, 4 : 4 + pad], t(wide_p)[:, 4 : 4 + pad]
    assert not r_view.is_contiguous()
    width, col0 = pad * w + 13, 6
    shift = int(n_cols).bit_length()
    if keys:
        out = torch.full((g, width), -9, dtype=torch.int32)
        got = gather.class_gather_keys(
            t(table), p_view, r_view, rows_pad, n_cols, shift, out=out, col0=col0
        )
        assert got is out
        want = gather.class_gather_keys_plain(t(table), t(pos), t(rows), rows_pad, n_cols, shift)
        assert torch.equal(out[:, col0 : col0 + pad * w], want)
        spans = [out]
    else:
        out = tuple(torch.full((g, width), -9, dtype=torch.int32) for _ in range(2))
        got = gather.class_gather(
            t(table), p_view, r_view, rows_pad, n_cols, out=out, col0=col0
        )
        assert got is out
        want = gather.class_gather_plain(t(table), t(pos), t(rows), rows_pad, n_cols)
        for o, w_ in zip(out, want):
            assert torch.equal(o[:, col0 : col0 + pad * w], w_)
        spans = list(out)
    for o in spans:
        assert (o[:, :col0] == -9).all() and (o[:, col0 + pad * w :] == -9).all()


def test_empty_groups():
    table = torch.zeros((4, 3), dtype=torch.int32)
    for g, pad in ((0, 5), (3, 0)):
        z = torch.zeros((g, pad), dtype=torch.int32)
        r, c = gather.class_gather(table, z, z, 8, 100)
        assert r.shape == c.shape == (g, pad * 3)
        k = gather.class_gather_keys(table, z, z, 8, 100, 7)
        assert k.shape == (g, pad * 3)


def test_cpu_tensors_launch_nothing():
    gather.class_gather.launches = 0
    gather.class_gather_keys.launches = 0
    table, rows, pos, rows_pad, n_cols = class_case(4, 3)
    gather.class_gather(t(table), t(pos), t(rows), rows_pad, n_cols)
    gather.class_gather_keys(t(table), t(pos), t(rows), rows_pad, n_cols, 7)
    assert gather.class_gather.launches == 0
    assert gather.class_gather_keys.launches == 0


def bad_call(label):
    """``(table, pos, rows, out width or None, col0)`` of a call the kernels
    do not take."""
    table, rows, pos, _, _ = class_case(4, 9)
    T, R, P = t(table), t(rows), t(pos)
    return {
        "int64 table": (T.long(), P, R, None, 0),
        "empty table": (T[:0], P, R, None, 0),
        "non-contiguous table": (t(np.zeros((4, 8), np.int32))[:, ::2], P, R, None, 0),
        "shapes differ": (T, P[:, :3], R, None, 0),
        "1-D positions": (T, P[0], R[0], None, 0),
        "strided columns": (T, t(np.zeros((5, 24), np.int32))[:, ::2], R, None, 0),
        "out too narrow": (T, P, R, 12 * 4 - 1, 0),
        "col0 past the end": (T, P, R, 12 * 4, 1),
    }[label]


@pytest.mark.parametrize("label", [
    "int64 table", "empty table", "non-contiguous table", "shapes differ",
    "1-D positions", "strided columns", "out too narrow", "col0 past the end",
])
def test_wrappers_raise_on_what_the_kernels_do_not_take(label):
    table, pos, rows, width, col0 = bad_call(label)

    def out(n):
        if width is None:
            return None
        outs = tuple(torch.zeros((pos.shape[0], width), dtype=torch.int32)
                     for _ in range(n))
        return outs if n == 2 else outs[0]

    with pytest.raises(ValueError):
        gather.class_gather(table, pos, rows, 8, 100, out=out(2), col0=col0)
    with pytest.raises(ValueError):
        gather.class_gather_keys(table, pos, rows, 8, 100, 7, out=out(1), col0=col0)


def test_keys_must_pack_into_int32():
    table, rows, pos, _, _ = class_case(2, 4)
    with pytest.raises(ValueError, match="pack"):
        gather.class_gather_keys(t(table), t(pos), t(rows), 1 << 20, 100, 12)
