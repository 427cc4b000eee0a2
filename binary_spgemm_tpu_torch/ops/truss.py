"""The device-resident k-truss peel: :func:`k_truss_device`, the route of
``graph.k_truss(resident=True)``.

The graph of round r, G_r, is a live mask over A's entries that stays on
the device.  A round computes every entry's support, the candidates (i, k,
j) of G_r·G_r that land on it, and drops the live entries below k - 2, all
at once (the synchronous peel).  One device read a round gives the entries
left and the sizes of the next round's streams; the surviving
mask leaves the device once, as the canonical host CSR of A's live entries.

Two routes, as the counting family routes:

* ELL: A's own ``masked=True`` plan, the one :func:`..ell.cached_executor`
  finds (as ``triangle_count`` does), and its staged mask, never re-planned
  on the host.  A candidate counts only where both of its legs (i, k) and
  (k, j) are live.  The first round expands the plan as staged; each later
  round repacks the live entries of every chunk's class span into spans cut
  to the widest chunk's live count (:meth:`_EllLayout.entries`), so a dead
  A leg expands to nothing and round r sorts about what G_r's entries
  expand to in A's tables, where the slots of dead B legs hold the
  sentinel.  :class:`_EllLayout` maps every staged slot to its entry of A.
* ESC (``chunk_flops`` given, or the plan past ``AUTO_ELL_MAX_SLOTS``): A's
  flop-bounded row chunks, each round expanding the chunk's live entries
  against G_r's live CSR, compacted on the device, into a stream padded to
  the chunk's live candidate count.

The round's read carries the sizes of the next round's streams: the widest
live count of each class span (ELL), each chunk's live candidates (ESC).
An entry's support is read from its chunk's sorted candidate keys by two
``torch.searchsorted`` of its own key (right minus left).
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bcsr import BCSR
from ..utils.trace import count, span
from .ell import (
    AUTO_ELL_MAX_SLOTS,
    _assemble_stream_2d,
    _unpack_entries,
    _unpack_tables,
    cached_executor,
)
from .spgemm import (
    DEFAULT_CHUNK_FLOPS,
    INT,
    INT32_MAX,
    _pair_key,
    _sort,
    _sort_keys,
    expand_pairs,
    pad_bucket,
    packable,
    require_int32_operands,
    resolve_device,
    row_flops,
    uniform_chunk_plan,
)

__all__ = ["k_truss_device"]

_I64_MAX = torch.iinfo(torch.int64).max


def _rank_within(keys: np.ndarray) -> np.ndarray:
    """Each element's rank among the elements of equal key, in index order."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    first = np.repeat(start, np.diff(np.r_[start, len(ks)]))
    rank = np.empty(len(keys), np.int64)
    rank[order] = np.arange(len(keys)) - first
    return rank


def _pack(local, col, bl: int, packed: bool, fill):
    """The sort keys of ``(local row, col)`` numpy pairs, as the stream packs
    them (int32 ``(row << bl) | col``, else int64 ``(row << 32) | col``);
    ``local < 0`` marks padding, which gets ``fill``."""
    shift = bl if packed else 32
    key = (local.astype(np.int64) << shift) | col.astype(np.int64)
    return np.where(local >= 0, key, fill).astype(np.int32 if packed else np.int64)


class _Keys:
    """What a route's candidate keys look like: packed int32 ``(row << bl) |
    col`` where ``packable(rows_pad, n_cols)``, else the int64 pair key."""

    def __init__(self, rows_pad: int, n_cols: int):
        self.bl = int(n_cols).bit_length()
        self.packed = packable(rows_pad, n_cols)
        self.fill = INT32_MAX if self.packed else _I64_MAX

    def of(self, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        return (row << self.bl) | col if self.packed else _pair_key(row, col)


def _support_of(key_s: torch.Tensor, f_key: torch.Tensor) -> torch.Tensor:
    """How many of the sorted keys equal each of ``f_key`` (along the last
    axis)."""
    return (torch.searchsorted(key_s, f_key, right=True, out_int32=True)
            - torch.searchsorted(key_s, f_key, out_int32=True))


def _ell_keys(tables, entry_rows, entry_pos, *, n_chunks: int, rows_pad: int,
              n_cols: int, widths, pads, sort_pad: int, device=None):
    """One dispatch group's ``[n_chunks, sort_pad]`` candidate keys (the
    batched engine's stream: class expansions, separators, sentinel fill),
    packed int32 where they pack, else the int64 pair keys."""
    args = (tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols, widths, pads,
            sort_pad)
    if packable(rows_pad, n_cols):
        return _assemble_stream_2d(*args, shift=int(n_cols).bit_length(), device=device)
    return _pair_key(*_assemble_stream_2d(*args, device=device))


class _EllLayout:
    """A masked ELL plan's staged slots mapped to the entries of A (= B) they
    hold, on the device: ``er_eid`` / ``ep_eid`` beside the staged entry
    arrays (an entry's A leg; an inlined class's B-row values), ``tab_eid``
    beside the flat tables (B legs), ``f_eid`` / ``f_key`` beside the staged
    mask (each entry's slot and its sort key); index ``nnz`` stands for a
    slot that never changes.  Built on the host from the planner's own
    placement (each entry of A in its chunk's span of its B row's width
    class, in CSR order) and checked against what the plan staged."""

    def __init__(self, ex, a: BCSR):
        n, nnz, dev = a.n_rows, a.nnz, ex.device
        ptr, col = a.indptr.astype(np.int64), a.indices.astype(np.int64)
        lens = np.diff(ptr)
        widths = np.asarray(ex.widths, np.int64)
        pads = np.asarray(ex.pads, np.int64)
        inline = np.asarray(ex.inline, bool)
        k_tot = ex.n_groups * ex.group_size
        # B's rows in the plan's width classes: the eighth-octave bucket
        # (EllB.build's), raised to the smallest plan width at or above it
        cls_row = np.full(n, -1, np.int64)
        nz = lens > 0
        if nz.any():
            w = lens[nz]
            step = np.maximum(np.left_shift(1, np.frexp(w * 2.0 - 1)[1] - 1) // 8, 1)
            cls_row[nz] = np.searchsorted(widths, (w + step - 1) // step * step)
        if ex.row_sets is None:
            ch_row = np.searchsorted(ex.bounds, np.arange(n), side="right") - 1
            local = np.arange(n) - ex.bounds[ch_row]
        else:
            ch_row = ex._assign.astype(np.int64)
            local = _rank_within(ch_row)
        row_e = np.repeat(np.arange(n), lens)
        ch_e = ch_row[row_e]
        # A legs: entry e in the span of its column's class in its chunk
        e = np.flatnonzero(cls_row[col] >= 0)
        ce, ke = cls_row[col[e]], ch_e[e]
        rank = _rank_within(ke * max(len(widths), 1) + ce)
        if (rank >= pads[ce]).any():
            raise RuntimeError("k-truss layout: a class span overflows its pad")
        P, offs = int(pads.sum()), np.r_[0, np.cumsum(pads)]
        er_slot = ke * P + offs[ce] + rank
        er_eid = np.full(k_tot * P, nnz, np.int64)
        er_eid[er_slot] = e
        er_want = np.full(k_tot * P, ex.rows_pad, np.int64)
        er_want[er_slot] = local[row_e[e]]
        # inlined classes stage B-row values beside each A entry: B legs
        spans = np.where(inline, pads * widths, pads)
        P_ep, offs_ep = int(spans.sum()), np.r_[0, np.cumsum(spans)]
        ep_base = ke * P_ep + offs_ep[ce] + rank * np.where(inline[ce], widths[ce], 1)
        ep_eid = np.full(k_tot * P_ep, nnz, np.int64)
        ep_check = [(ep_base[~inline[ce]], _rank_within(cls_row)[col[e[~inline[ce]]]])]
        tab_eid = []
        for c, wc in enumerate(widths):
            t = np.arange(wc)
            if inline[c]:
                sel = ce == c
                dst = (ep_base[sel][:, None] + t).ravel()
                ep_eid[dst] = self._legs(ptr, lens, nnz, col[e[sel]], t)
                ep_check.append((dst, None))
            else:
                tab_eid.append(self._legs(ptr, lens, nnz, np.flatnonzero(cls_row == c), t))
        tab_eid = np.concatenate(tab_eid) if tab_eid else np.zeros(0, np.int64)
        # the staged mask: each bin's entries in CSR order from its slot 0
        f_ptr, f_idx = ex.stage_mask(a)
        f_pad = f_idx.shape[1]
        f_slot = ch_e * f_pad + _rank_within(ch_e)
        self.keys = _Keys(ex.rows_pad, ex.n_cols)
        f_row = np.full(k_tot * f_pad, -1, np.int64)
        f_row[f_slot] = local[row_e]
        f_col = np.zeros(k_tot * f_pad, np.int64)
        f_col[f_slot] = col
        f_key = _pack(f_row, f_col, self.keys.bl, self.keys.packed, self.keys.fill)
        f_eid = np.full(k_tot * f_pad, nnz, np.int64)
        f_eid[f_slot] = np.arange(nnz)
        self._check(ex, col, er_want, ep_eid, ep_check, tab_eid, f_idx, f_slot)

        def up(x, dtype=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

        self.er_eid, self.ep_eid, self.tab_eid = up(er_eid), up(ep_eid), up(tab_eid)
        self.f_eid = up(f_eid, torch.int64).view(k_tot, f_pad)
        self.f_key = torch.from_numpy(f_key).to(dev).view(k_tot, f_pad)
        # each entry column's class, each ep column's entry column and slot
        # in it (an inlined class stages its entries' B-row values, w a column)
        self.widths, self.inline, self.pads = widths, inline, pads
        col_cls = np.repeat(np.arange(len(widths)), pads)
        per = np.where(inline, widths, 1)[col_cls]
        self.col_cls, self.span0 = up(col_cls, torch.int64), up(offs[:-1], torch.int64)
        self.ep_col = up(np.repeat(np.arange(P), per), torch.int64)
        self.ep_t = up(np.arange(P_ep) - np.repeat(np.cumsum(per) - per, per))
        self.ep_w = up(np.repeat(per, per))
        self.ep_cls = up(np.repeat(col_cls, per), torch.int64)
        self.P, self.P_ep, self.k_tot = P, P_ep, k_tot
        self.real = up(er_eid < nnz, torch.bool).view(k_tot, P)

    @staticmethod
    def _legs(ptr, lens, nnz: int, rows, t):
        """The entries of B's ``rows`` at slots ``t`` of their ELL rows
        (``nnz`` past a row's end), flattened row by row."""
        src = ptr[rows][:, None] + t
        return np.where(t < lens[rows][:, None], src, nnz).ravel()

    @staticmethod
    def _check(ex, col, er_want, ep_eid, ep_check, tab_eid, f_idx, f_slot):
        """The layout against what the plan staged: a planner whose placement
        moved would otherwise peel the wrong legs."""
        n_cols, nnz = ex.n_cols, len(col)
        ep_all = ex.ep_all.cpu().numpy().ravel()
        tables = ex.tables_flat.cpu().numpy()
        col_n = np.r_[col, n_cols]
        ok = (np.array_equal(ex.er_all.cpu().numpy().ravel(), er_want)
              and np.array_equal(tables, col_n[tab_eid])
              and np.array_equal(f_idx.cpu().numpy().ravel()[f_slot], col))
        for dst, want in ep_check:
            ok = ok and np.array_equal(ep_all[dst], col_n[ep_eid[dst]] if want is None
                                       else want)
        if not ok:
            raise RuntimeError("k-truss layout does not match the staged masked plan")

    def _live_counts(self, alive: torch.Tensor):
        """``(rank, count)`` of the live entry slots ``alive`` ``[k_tot, P]``:
        each slot's rank among the live slots of its class span, and each
        span's live count ``[k_tot, C]`` (one 1-D scan: a scan along a long
        last axis runs a row a block; the rows' carries cancel)."""
        csum = torch.cumsum(alive.view(-1), 0, dtype=INT).view(alive.shape)
        before = csum - alive.to(INT)
        start = torch.index_select(before, 1, self.span0)
        rank = before - torch.index_select(start, 1, self.col_cls)
        ends = torch.cat([start[:, 1:], csum[:, -1:]], 1)
        return rank, ends - start

    def sizes(self, keep: torch.Tensor, ex) -> torch.Tensor:
        """The next round's pads: each class span's widest live count over
        the chunks (for the round's read)."""
        keep_ext = torch.cat([keep, keep.new_ones(1)])
        alive = torch.index_select(keep_ext, 0, self.er_eid).view(self.k_tot, self.P)
        alive &= self.real
        return self._live_counts(alive)[1].amax(0).long()

    @staticmethod
    def next_sizes(counts):
        """The pads of the next round's class spans, from :meth:`sizes`."""
        return [pad_bucket(int(c), minimum=8) if c else 0 for c in counts]

    def entries(self, ex, live_ext: torch.Tensor, pads):
        """The staged entry arrays with the dead A legs dropped: every
        chunk's live entries of a class span moved to the front of a span
        cut to ``pads[c]``; an inlined class's dead B legs to the sentinel.
        Returns ``(er, ep, pads, ep_spans, sort_pad)``."""
        ep_vals = torch.where(torch.index_select(live_ext, 0, self.ep_eid).view_as(ex.ep_all),
                              ex.ep_all, ex.n_cols)
        if pads is None:  # the first round: every entry is live
            spans = np.where(self.inline, self.pads * self.widths, self.pads)
            return ex.er_all, ep_vals, tuple(self.pads), tuple(spans), ex.sort_pad
        pads = np.asarray(pads, np.int64)
        spans = np.where(self.inline, pads * self.widths, pads)
        P, P_ep = int(pads.sum()), int(spans.sum())
        dev = live_ext.device
        offs = torch.from_numpy(np.r_[0, np.cumsum(pads)[:-1]]).to(dev)
        offs_ep = torch.from_numpy(np.r_[0, np.cumsum(spans)[:-1]]).to(dev)
        alive = torch.index_select(live_ext, 0, self.er_eid).view(self.k_tot, self.P)
        alive &= self.real
        rank, _ = self._live_counts(alive)
        dst = torch.where(alive, torch.index_select(offs, 0, self.col_cls) + rank, P)
        er = torch.full((self.k_tot, P + 1), ex.rows_pad, dtype=INT, device=dev)
        er.scatter_(1, dst.long(), ex.er_all)
        rank_ep = torch.index_select(rank, 1, self.ep_col)
        dst = torch.where(torch.index_select(alive, 1, self.ep_col),
                          torch.index_select(offs_ep, 0, self.ep_cls) + rank_ep * self.ep_w
                          + self.ep_t, P_ep)
        ep = torch.zeros((self.k_tot, P_ep + 1), dtype=INT, device=dev)
        ep.scatter_(1, dst.long(), ep_vals)
        slots = int((pads * self.widths).sum())
        return (er[:, :P], ep[:, :P_ep], tuple(int(p) for p in pads),
                tuple(int(x) for x in spans), pad_bucket(max(slots + ex.rows_pad, 8), div=32))

    def support(self, ex, live: torch.Tensor, support: torch.Tensor, pads):
        """One round's support of every entry into ``support`` (index ``nnz``
        takes the mask's padding), on spans cut to ``pads`` (``None``: the
        plan's own)."""
        live_ext = torch.cat([live, live.new_ones(1)])
        keep = torch.index_select(live_ext, 0, self.tab_eid)
        tables = _unpack_tables(torch.where(keep, ex.tables_flat, ex.n_cols),
                                ex.table_shapes)
        er, ep, pads, spans, sort_pad = self.entries(ex, live_ext, pads)
        g = ex.group_size
        for row0 in ex._row0s():
            with span("expand"):
                ers, eps = _unpack_entries(er, ep, row0, g, pads, spans)
                key = _ell_keys(tables, ers, eps, n_chunks=g, rows_pad=ex.rows_pad,
                                n_cols=ex.n_cols, widths=ex.widths, pads=pads,
                                sort_pad=sort_pad, device=live.device)
            with span("sort"):
                key = _sort_keys(key)
            sup = _support_of(key, self.f_key[row0 : row0 + g])
            support.scatter_(0, self.f_eid[row0 : row0 + g].reshape(-1), sup.reshape(-1))


class _EscLayout:
    """The ESC route's chunks of A (``uniform_chunk_plan``, the join's
    packing rule) with each entry's chunk and sort key, on the device."""

    def __init__(self, a: BCSR, chunk_flops: int, device: torch.device):
        n = a.n_rows
        rf = row_flops(a, a)
        self.chunks, self.rows_pad, self.nnz_pad, _ = uniform_chunk_plan(
            a, rf, chunk_flops, n)
        self.keys = _Keys(self.rows_pad, n)
        r0s = np.array([r0 for r0, _ in self.chunks], np.int64)
        ch_row = np.repeat(np.arange(len(self.chunks)),
                           [r1 - r0 for r0, r1 in self.chunks])
        ptr = a.indptr.astype(np.int64)
        row_e = np.repeat(np.arange(n), np.diff(ptr))
        ch_e = ch_row[row_e]
        f_key = _pack(row_e - r0s[ch_e], a.indices, self.keys.bl, self.keys.packed, 0)
        self.entries = [(int(ptr[r0]), int(ptr[r1])) for r0, r1 in self.chunks]
        self.first = [int(rf[r0:r1].sum()) for r0, r1 in self.chunks]
        self.f_key = torch.from_numpy(f_key).to(device)
        self.chunk_of = torch.from_numpy(ch_e).to(device)

    def support(self, graph, live, support, flops):
        """One round: G_r's live CSR compacted on the device, then each
        chunk's live entries expanded against it into ``flops[c]`` slots,
        sorted, and each entry's support read off."""
        nnz, n = live.shape[0], graph.n_cols
        dev = live.device
        lc = torch.cat([live.new_zeros(1, dtype=INT), torch.cumsum(live, 0, dtype=INT)])
        ptr_r = torch.index_select(lc, 0, graph.a_ptr)
        dst = torch.where(live, lc[:-1], nnz).long()
        idx_r = torch.full((nnz + 1,), n, dtype=INT, device=dev).scatter_(
            0, dst, graph.a_idx)[:nnz]
        span_r = torch.arange(self.nnz_pad, dtype=INT, device=dev)
        for (r0, r1), (e0, e1), pad in zip(self.chunks, self.entries, flops):
            if e0 == e1:
                continue
            with span("expand"):
                c_ptr = ptr_r[r0 : r1 + 1] - ptr_r[r0]
                c_ptr = torch.cat([c_ptr, c_ptr[-1:].expand(self.rows_pad - (r1 - r0))])
                c_idx = torch.index_select(
                    idx_r, 0, (span_r + ptr_r[r0]).clamp_(max=max(nnz - 1, 0)))
                row, col = expand_pairs(c_ptr, c_idx, c_ptr[-1], ptr_r, idx_r, n_cols=n,
                                        flops_pad=pad, check_total=False)
                key = self.keys.of(row, col)
            with span("sort"):
                key = _sort(key).values
            support[e0:e1] = _support_of(key, self.f_key[e0:e1])

    def sizes(self, keep: torch.Tensor, graph) -> torch.Tensor:
        """Each chunk's live candidates next round, for the round's read: an
        entry's candidates are its column's live degree."""
        lc = torch.cat([keep.new_zeros(1, dtype=INT), torch.cumsum(keep, 0, dtype=INT)])
        ends = torch.index_select(lc, 0, graph.a_ptr)
        deg = ends[1:] - ends[:-1]
        cand = torch.where(keep, torch.index_select(deg, 0, graph.a_idx), 0)
        flops = torch.zeros(len(self.chunks), dtype=torch.int64, device=keep.device)
        return flops.index_add_(0, self.chunk_of, cand.long())

    @staticmethod
    def next_sizes(flops):
        """Each chunk's expansion pad, from :meth:`sizes`."""
        return [pad_bucket(max(int(f), 8)) for f in flops]


class _Graph:
    """A's CSR on the device (ESC's live CSR and live degrees):
    ``a_ptr`` int64 ``[n + 1]``, ``a_idx`` int32 ``[nnz]``."""

    def __init__(self, a: BCSR, device: torch.device):
        self.n_cols = a.n_cols
        self.a_ptr = torch.from_numpy(a.indptr.astype(np.int64)).to(device)
        self.a_idx = torch.from_numpy(a.indices.astype(np.int32)).to(device)


def _route(a: BCSR, chunk_flops, device):
    """``(executor or graph, layout, first round's sizes)``: A's masked ELL
    plan while it fits, with its layout built once and kept on it; else (or
    with ``chunk_flops``) ESC on A's own chunks."""
    if chunk_flops is None:
        try:
            ex = cached_executor(a, a, masked=True, device=device)
        except OverflowError:
            ex = None
        if ex is not None and ex.total_slots <= AUTO_ELL_MAX_SLOTS:
            lay = getattr(ex, "_truss_layout", None)
            if lay is None:
                with span("plan.stage", always=True):
                    lay = ex._truss_layout = _EllLayout(ex, a)
            return ex, lay, None
    graph = _Graph(a, device)
    lay = _EscLayout(a, chunk_flops or DEFAULT_CHUNK_FLOPS, device)
    return graph, lay, lay.next_sizes(lay.first)


def k_truss_device(a: BCSR, k: int, *, chunk_flops: int | None = None,
                   device: str | torch.device = "cuda") -> BCSR:
    """The k-truss of A (k >= 3) by the synchronous peel on ``device``:
    bit-equal to the host loop of ``graph.k_truss(resident=False)``."""
    with span("call.k_truss"):
        with span("call.check"):
            if k < 3:
                raise ValueError("k-truss needs k >= 3")
            if a.n_rows != a.n_cols:
                raise ValueError("k-truss needs a square adjacency matrix")
            require_int32_operands(a)
            a = a.sum_duplicates()
        nnz = a.nnz
        if nnz == 0:
            return a
        device = resolve_device(device)
        ex, lay, sizes = _route(a, chunk_flops, device)
        live = torch.ones(nnz, dtype=torch.bool, device=lay.f_key.device)
        support = torch.zeros(nnz + 1, dtype=INT, device=live.device)
        left = nnz
        while True:
            with span("ktruss.round"):
                with span("ktruss.support"):
                    lay.support(ex, live, support, sizes)
                with span("ktruss.filter"):
                    live = live & (support[:nnz] >= k - 2)
                    read = torch.cat([live.sum().view(1), lay.sizes(live, ex)])
                with span("sync.peel"):
                    read = read.cpu().numpy()
            count("ktruss.rounds")
            now = int(read[0])
            count("ktruss.dropped", left - now)
            if now in (left, 0):
                break
            left = now
            sizes = lay.next_sizes(read[1:])
        with span("sync.result"):
            mask = live.cpu().numpy()
        kept = np.r_[0, np.cumsum(mask, dtype=np.int64)]
        return BCSR(kept[a.indptr.astype(np.int64)], a.indices[mask], a.shape)
