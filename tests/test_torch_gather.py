"""The class-table gathers P3 (``class_gather``, ``class_gather_group``)
and P4 (``class_gather_keys``, ``class_gather_keys_group``) on the CPU:
their plain versions against the JAX package's ``_expand_class`` /
``_expand_class_2d`` and against the check of the Pallas prototype they
replace (``benchmarks/pallas_gather.py``), the port's expansion of inlined
and gathered classes, writes into a column span of a wider stream, a whole
dispatch group of classes at once, and the wrappers' contract (no launch and
no count on a CPU tensor, raise on what the kernels do not take); then the
host side of the group kernel: its descriptors, their split past the
per-launch cap, its division by the width and its cover of each span."""
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


GROUP_WIDTHS = [1, 2, 3, 5, 7, 16, 40, 200]


def group_case(seed, widths=GROUP_WIDTHS, g=5, pad=12, inline=(),
               rows_pad=8, n_cols=100):
    """One dispatch group's classes of ``widths`` with the staged inputs as
    column slices of wider entry arrays (``_unpack_entries``), each class
    with clamped and negative positions and sentinel rows; the classes at
    the indices in ``inline`` inlined (B's row values in place of positions).
    Returns ``(tables, entry_rows, entry_pos, pads)`` as numpy arrays and
    torch views."""
    np_tables, np_rows, np_pos = [], [], []
    for k, w in enumerate(widths):
        table, rows, pos, _, _ = class_case(w, seed + k, g=g, pad=pad,
                                            rows_pad=rows_pad, n_cols=n_cols)
        if k in inline:
            pos = table[np.clip(pos, 0, table.shape[0] - 1)].reshape(g, -1)
            table = None
        np_tables.append(table)
        np_rows.append(rows)
        np_pos.append(pos)
    er_all = t(np.concatenate([np.full((g, 3), 77, np.int32)] + np_rows, axis=1))
    ep_all = t(np.concatenate([np.full((g, 5), 66, np.int32)] + np_pos, axis=1))
    er, ep, off_r, off_p = [], [], 3, 5
    for r, p in zip(np_rows, np_pos):
        er.append(er_all[:, off_r : off_r + r.shape[1]])
        ep.append(ep_all[:, off_p : off_p + p.shape[1]])
        off_r += r.shape[1]
        off_p += p.shape[1]
    tables = [None if x is None else t(x) for x in np_tables]
    return (np_tables, np_rows, np_pos), (tables, er, ep), [pad] * len(widths)


def jax_spans(np_case, widths, rows_pad, n_cols, shift, width, col0, fill):
    """The JAX package's ``_expand_class_2d`` of each class, written into its
    column span from ``col0`` of a ``[g, width]`` array filled with ``fill``."""
    tables, rows, pos = np_case
    outs = [np.full((rows[0].shape[0], width), fill, np.int32)
            for _ in range(1 if shift is not None else 2)]
    off = col0
    for tbl, r, p, w in zip(tables, rows, pos, widths):
        got = jax_expand(tbl, r, p, rows_pad, n_cols, w, shift=shift)
        got = (got,) if shift is not None else got
        for o, x in zip(outs, got):
            o[:, off : off + x.shape[1]] = x
        off += got[0].shape[1]
    return outs


@pytest.mark.parametrize("shift", [None, 7])
def test_group_matches_jax_and_the_per_class_composition(shift):
    """The group entry point (its CPU path is the plain version) over
    classes of widths 1 to 200 from column slices of staged arrays, written
    from an odd column into a stream whose row stride is not a multiple of
    4, equals the JAX package's per-class expansion in each span and the
    one-class entry points, and leaves every other column as it was."""
    rows_pad, n_cols, col0 = 8, 100, 5
    np_case, (tables, er, ep), pads = group_case(3)
    width = col0 + sum(p * w for p, w in zip(pads, GROUP_WIDTHS)) + 6
    assert width % 4 != 0
    want = jax_spans(np_case, GROUP_WIDTHS, rows_pad, n_cols, shift, width, col0, -9)
    classes, off = [], col0
    for tbl, r, p, w, pad in zip(tables, er, ep, GROUP_WIDTHS, pads):
        assert not r.is_contiguous() and not p.is_contiguous()
        classes.append((tbl, p, r, off))
        off += pad * w
    outs = [torch.full((5, width), -9, dtype=torch.int32) for _ in want]
    one = [o.clone() for o in outs]
    if shift is not None:
        got = gather.class_gather_keys_group(classes, rows_pad, n_cols, shift, outs[0])
        assert got is outs[0]
        for c in classes:
            gather.class_gather_keys(*c[:3], rows_pad, n_cols, shift, out=one[0],
                                     col0=c[3])
    else:
        got = gather.class_gather_group(classes, rows_pad, n_cols, outs)
        assert got[0] is outs[0] and got[1] is outs[1]
        for c in classes:
            gather.class_gather(*c[:3], rows_pad, n_cols, out=tuple(one), col0=c[3])
    for o, o1, w_ in zip(outs, one, want):
        assert np.array_equal(o.numpy(), w_)
        assert torch.equal(o, o1)
    assert np.sum(want[0] == (rows_pad if shift is None else (rows_pad << shift) | n_cols)) > 0


@pytest.mark.parametrize("shift", [None, 7])
def test_expand_classes_with_an_inlined_class_matches_jax(shift):
    """``ops/ell.py::_expand_classes`` (the group launch for the gathered
    classes, torch ops for the inlined one) equals the JAX package's
    per-class expansion written into the spans from column 0."""
    rows_pad, n_cols = 8, 100
    np_case, (tables, er, ep), pads = group_case(11, inline=(2,))
    width = sum(p * w for p, w in zip(pads, GROUP_WIDTHS)) + 3
    want = jax_spans(np_case, GROUP_WIDTHS, rows_pad, n_cols, shift, width, 0, -9)
    outs = [torch.full((5, width), -9, dtype=torch.int32) for _ in want]
    out = outs[0] if shift is not None else tuple(outs)
    end = tp_ell._expand_classes(tables, er, ep, GROUP_WIDTHS, pads, out,
                                 rows_pad=rows_pad, n_cols=n_cols, shift=shift)
    assert end == width - 3
    for o, w_ in zip(outs, want):
        assert np.array_equal(o.numpy(), w_)


def test_group_with_no_gathered_class_writes_and_launches_nothing():
    gather.class_gather.launches = 0
    gather.class_gather_keys.launches = 0
    outs = tuple(torch.full((4, 9), -3, dtype=torch.int32) for _ in range(2))
    table = t(np.zeros((3, 2), np.int32))
    empty = torch.zeros((4, 0), dtype=torch.int32)
    for classes in ([], [(table, empty, empty, 1)]):
        assert gather.class_gather_group(classes, 8, 100, outs)[0] is outs[0]
        assert gather.class_gather_keys_group(classes, 8, 100, 7, outs[1]) is outs[1]
        assert all((o == -3).all() for o in outs)
    _, (tables, er, ep), pads = group_case(5, widths=[2, 3], inline=(0, 1))
    assert tables == [None, None]
    key = torch.full((5, 60), -3, dtype=torch.int32)
    assert tp_ell._expand_classes(tables, er, ep, [2, 3], pads, key, rows_pad=8,
                                  n_cols=100, shift=7) == 60
    assert gather.class_gather.launches == gather.class_gather_keys.launches == 0


@pytest.mark.parametrize("keys", [False, True])
def test_descriptor_split_past_the_cap_gives_the_same_stream(keys, monkeypatch):
    """Past ``GROUP_CAP`` classes the wrapper splits the group into several
    launches; with the cap set to 3, 8 classes go in batches of 3, 3 and 2
    and the stream is the one the whole group gives."""
    rows_pad, n_cols, shift = 8, 100, 7
    _, (tables, er, ep), pads = group_case(21)
    classes, off = [], 2
    for tbl, r, p, w, pad in zip(tables, er, ep, GROUP_WIDTHS, pads):
        classes.append((tbl, p, r, off))
        off += pad * w
    assert [len(b) for b in gather._batches(classes)] == [len(classes)]

    def run():
        outs = tuple(torch.full((5, off + 1), -1, dtype=torch.int32) for _ in range(2))
        if keys:
            return (gather.class_gather_keys_group(classes, rows_pad, n_cols, shift,
                                                   outs[0]),)
        return gather.class_gather_group(classes, rows_pad, n_cols, outs)

    whole = run()
    monkeypatch.setattr(gather, "GROUP_CAP", 3)
    assert [len(b) for b in gather._batches(classes)] == [3, 3, 2]
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


def test_descriptors_pack_each_class():
    """The descriptor of each class holds its pointers, row strides, column
    offset, span, width, table rows and divider, in the layout of
    ``csrc/gather.cu``'s ``ClassDesc`` (72 bytes)."""
    import ctypes

    _, (tables, er, ep), pads = group_case(8, widths=[3, 40])
    classes = [(tables[0], ep[0], er[0], 7), (tables[1], ep[1], er[1], 7 + 36)]
    descs = gather._descriptors(classes)
    assert ctypes.sizeof(gather._ClassDesc) == 72
    for d, (tbl, p, r, col0) in zip(descs, classes):
        assert (d.table, d.pos, d.rows) == (tbl.data_ptr(), p.data_ptr(), r.data_ptr())
        assert (d.pos_stride, d.rows_stride) == (p.stride(0), r.stride(0))
        assert (d.col0, d.span, d.w, d.nc) == (col0, 12 * tbl.shape[1], tbl.shape[1],
                                               tbl.shape[0])
        assert (d.magic, d.mshift) == gather._divider(tbl.shape[1])


@pytest.mark.parametrize(
    "w", [1, 2, 3, 5, 7, 16, 24, 40, 200, 641, 10240, 65537, (1 << 20) + 1,
          (1 << 30) - 1, 1 << 30, (1 << 31) - 1])
def test_divider_is_exact_below_2_31(w):
    """The kernel's one division per run, ``(umulhi(c, magic) + c) >>
    shift``, equals ``c // w`` for slot indices up to 2^31 - 1."""
    INT32_MAX = gather.INT32_MAX
    magic, s = gather._divider(w)
    assert 0 <= magic < 1 << 32 and 0 <= s <= 31
    rng = np.random.default_rng(w)
    c = np.concatenate([
        rng.integers(0, INT32_MAX, 20000, dtype=np.uint64, endpoint=True),
        np.arange(0, 4 * w + 4, max(1, w // 64), dtype=np.uint64)[:5000],
        np.array([w - 1, w, w + 1, INT32_MAX, INT32_MAX - 1], dtype=np.uint64),
        (np.arange(1, 200, dtype=np.uint64) * np.uint64(w)) - np.uint64(1),
    ])
    c = c[c <= INT32_MAX]
    hi = (c * np.uint64(magic)) >> np.uint64(32)
    assert np.array_equal((hi + c) >> np.uint64(s), c // np.uint64(w))


@pytest.mark.parametrize("span", [1, 2, 3, 4, 5, 7, 8, 13, 4096, 4099, 8195])
def test_kernel_cover_writes_every_slot_once(span):
    """A model of the kernel's cover of one row's span: head slots up to the
    first 16-byte aligned address, runs of 4 from there in tiles of
    ``256 * 4`` runs, the rest one by one; for every alignment of the
    span's first slot, each slot is written exactly once."""
    q_tile = 256 * 4
    tiles = max(1, -(-(span >> 2) // q_tile))
    for first in range(4):  # the span's first slot, in int32 words mod 4
        head = min(span, (4 - first) % 4)
        nq = (span - head) >> 2
        written = np.zeros(span, np.int64)
        for tid in range(8):  # tile 0's scalar slots
            c = tid if tid < 4 else head + 4 * nq + tid - 4
            if c < (head if tid < 4 else span):
                written[c] += 1
        for tile in range(tiles):
            q = tile * q_tile + np.arange(q_tile)
            for c in 4 * q[q < nq] + head:
                assert (first + c) % 4 == 0  # the run starts 16-byte aligned
                written[c : c + 4] += 1
        assert (written == 1).all()
