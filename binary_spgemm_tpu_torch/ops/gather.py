"""Class-table row gathers: the sliced-ELL expansion of a dispatch group.

Two kernels written by hand for Hopper live in ``csrc/gather.cu``:

* P3 :func:`class_gather_group` — for every gathered width class of a
  dispatch group of ``g`` chunks or bins, the ``(row, col)`` candidate
  streams: slot ``(i, e*w + j)`` of the class's column span holds
  ``(rows[i, e], table[pos[i, e], j])``, or ``(rows_pad, n_cols)`` where
  the column is the table's sentinel or the row id is not below
  ``rows_pad`` (replaces ``benchmarks/pallas_gather.py::pallas_gather``);
* P4 :func:`class_gather_keys_group` — the same gather fused with the key
  pack, ``(row << shift) | col`` and the sentinel key ``(rows_pad << shift)
  | n_cols`` (replaces ``pallas_gather_keys`` there).

Each writes all the classes it is given, ``(table, pos, rows, col0)`` each,
into their column spans ``[col0, col0 + pad*w)`` of the caller's group
stream in one launch (more past :data:`GROUP_CAP` classes).
:func:`class_gather` and :func:`class_gather_keys` are the one-class case,
into a fresh ``[g, pad*w]`` stream or a span of ``out``.

Positions follow JAX's indexing, which the JAX package's expansion relies on:
a negative position counts from the end, then every position is clamped to
``[0, nc - 1]``.

For CUDA tensors a wrapper launches its kernel and counts each launch in
``class_gather.launches`` (P3) or ``class_gather_keys.launches`` (P4); a
group with no gathered class or no row launches nothing.  For CPU tensors it
computes the plain PyTorch versions (``*_plain`` below) into the same spans.
Anything the kernel does not take raises: there is no fallback to the plain
version on the card.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "GROUP_CAP",
    "class_gather",
    "class_gather_group",
    "class_gather_group_plain",
    "class_gather_keys",
    "class_gather_keys_group",
    "class_gather_keys_group_plain",
    "class_gather_keys_plain",
    "class_gather_plain",
]

INT32_MAX = (1 << 31) - 1
GROUP_CAP = 48  # classes per launch: kMaxClasses in csrc/gather.cu


class _ClassDesc(ctypes.Structure):
    """One class as the kernel takes it (``ClassDesc`` in ``csrc/gather.cu``)."""

    _fields_ = [
        ("table", ctypes.c_void_p),
        ("pos", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("pos_stride", ctypes.c_longlong),
        ("rows_stride", ctypes.c_longlong),
        ("col0", ctypes.c_longlong),
        ("span", ctypes.c_uint),
        ("magic", ctypes.c_uint),
        ("w", ctypes.c_int),
        ("nc", ctypes.c_int),
        ("mshift", ctypes.c_int),
        ("tile0", ctypes.c_uint),
    ]


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {
    "class_gather_group": [_PTR, _I32, _I32, _PTR, _PTR, _I64, _I32, _I32, _PTR],
    "class_gather_keys_group":
        [_PTR, _I32, _I32, _PTR, _I64, _I32, _I32, _I32, _I32, _PTR],
}


def _fn(name: str):
    from .._build import load

    lib = load("gather")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        layout = (lib.class_gather_desc_bytes(), lib.class_gather_max_classes())
        if layout != (ctypes.sizeof(_ClassDesc), GROUP_CAP):
            raise RuntimeError(
                f"csrc/gather.cu takes {layout[1]} classes of {layout[0]} bytes; "
                f"ops/gather.py packs {GROUP_CAP} of {ctypes.sizeof(_ClassDesc)}"
            )
        fn.argtypes = _SIG[name]
        fn.restype = ctypes.c_int
    return fn


def _divider(w: int) -> tuple[int, int]:
    """``(magic, shift)`` with ``c // w == ((c * magic >> 32) + c) >> shift``
    for every ``0 <= c < 2**31``: the round-up multiplier ``ceil(2**(32+s)
    / w)`` with ``s = ceil(log2 w)``, less its top bit 2**32."""
    s = (w - 1).bit_length()
    return -(-(1 << (32 + s)) // w) - (1 << 32), s


def _clamped(pos: torch.Tensor, nc: int) -> torch.Tensor:
    """Positions as JAX's indexing takes them: negatives from the end, then
    clamped into the table."""
    return torch.where(pos < 0, pos + nc, pos).clamp_(0, nc - 1)


def _gathered(table, pos, rows, rows_pad: int, n_cols: int):
    cols = table[_clamped(pos, table.shape[0])]  # [g, pad, w]
    r = rows[..., None].expand(cols.shape)
    return r, cols, (cols < n_cols) & (r < rows_pad)


def class_gather_plain(
    table: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
    rows_pad: int, n_cols: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of P3 for one class: indexing plus
    ``torch.where``."""
    shape = (pos.shape[0], pos.shape[1] * table.shape[1])
    r, cols, valid = _gathered(table, pos, rows, rows_pad, n_cols)
    return (torch.where(valid, r, rows_pad).reshape(shape),
            torch.where(valid, cols, n_cols).reshape(shape))


def class_gather_keys_plain(
    table: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
    rows_pad: int, n_cols: int, shift: int,
) -> torch.Tensor:
    """Plain PyTorch version of P4 for one class."""
    shape = (pos.shape[0], pos.shape[1] * table.shape[1])
    r, cols, valid = _gathered(table, pos, rows, rows_pad, n_cols)
    sentinel = (rows_pad << shift) | n_cols
    return torch.where(valid, (r << shift) | cols, sentinel).reshape(shape)


def class_gather_group_plain(classes, rows_pad: int, n_cols: int, out):
    """Plain version of P3 over a group: each class's plain version written
    into its column span of ``out = (rows_out, cols_out)``."""
    for table, pos, rows, col0 in classes:
        span = pos.shape[1] * table.shape[1]
        r, c = class_gather_plain(table, pos, rows, rows_pad, n_cols)
        out[0][:, col0 : col0 + span] = r
        out[1][:, col0 : col0 + span] = c
    return out


def class_gather_keys_group_plain(classes, rows_pad: int, n_cols: int, shift: int,
                                  out: torch.Tensor) -> torch.Tensor:
    """Plain version of P4 over a group, into the column spans of ``out``."""
    for table, pos, rows, col0 in classes:
        span = pos.shape[1] * table.shape[1]
        out[:, col0 : col0 + span] = class_gather_keys_plain(
            table, pos, rows, rows_pad, n_cols, shift)
    return out


def _check(what, table, pos, rows, outs, col0: int) -> int:
    """Raise on what the kernels do not take; return the span ``pad * w``."""
    def int32_2d(t, name):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(
                f"{what}: {name} must be a 2-D int32 tensor, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{what}: {name} needs a unit column stride")

    int32_2d(table, "table")
    if not table.is_contiguous() or min(table.shape) < 1:
        raise ValueError(
            f"{what}: the table must be contiguous and non-empty, got "
            f"{tuple(table.shape)}"
        )
    int32_2d(pos, "pos")
    int32_2d(rows, "rows")
    if pos.shape != rows.shape:
        raise ValueError(
            f"{what}: pos {tuple(pos.shape)} and rows {tuple(rows.shape)} differ"
        )
    g, pad = pos.shape
    span = pad * table.shape[1]
    if span > INT32_MAX:
        raise ValueError(f"{what}: {span} slots per row exceed int32")
    tensors = [table, pos, rows, *outs]
    if any(t.device != table.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {table.device}")
    for t in outs:
        int32_2d(t, "out")
        if t.shape[0] != g or not 0 <= col0 <= t.shape[1] - span:
            raise ValueError(
                f"{what}: columns [{col0}, {col0 + span}) of {g} rows do not "
                f"fit out {tuple(t.shape)}"
            )
        if t.shape != outs[0].shape or t.stride() != outs[0].stride():
            raise ValueError(f"{what}: the two outputs differ in shape or strides")
        if (t.data_ptr() - outs[0].data_ptr()) % 16:
            raise ValueError(f"{what}: the two outputs differ in 16-byte alignment")
    return span


def _batches(classes) -> list[list]:
    """The classes that have slots, in launches of at most ``GROUP_CAP``."""
    live = [c for c in classes if c[1].numel() and c[0].shape[1]]
    return [live[i : i + GROUP_CAP] for i in range(0, len(live), GROUP_CAP)]


def _descriptors(batch) -> ctypes.Array:
    """The kernel's class descriptors of one launch (``tile0`` is set by
    the launcher)."""
    descs = (_ClassDesc * len(batch))()
    for d, (table, pos, rows, col0) in zip(descs, batch):
        nc, w = table.shape
        d.table, d.pos, d.rows = table.data_ptr(), pos.data_ptr(), rows.data_ptr()
        d.pos_stride, d.rows_stride, d.col0 = pos.stride(0), rows.stride(0), col0
        d.span, d.w, d.nc = pos.shape[1] * w, w, nc
        d.magic, d.mshift = _divider(w)
    return descs


def _group(name, classes, outs, plain, counter, *tail) -> None:
    """Check every class, then write them: the plain version on the CPU,
    one launch of kernel ``name`` per batch on the card."""
    for table, pos, rows, col0 in classes:
        _check(name, table, pos, rows, outs, col0)
    batches = _batches(classes)
    if outs[0].device.type == "cpu":
        for batch in batches:
            plain(batch)
        return
    g, dev = outs[0].shape[0], outs[0].device
    for batch in batches:
        descs = _descriptors(batch)
        with torch.cuda.device(dev):
            err = _fn(name)(
                descs, len(batch), g, *(t.data_ptr() for t in outs),
                outs[0].stride(0), *tail,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        counter.launches += 1


def class_gather_group(classes, rows_pad: int, n_cols: int, out):
    """P3 over a dispatch group: each of ``classes``, ``(table, pos, rows,
    col0)``, written into columns ``col0 : col0 + pad*w`` of ``out =
    (rows_out, cols_out)``, which is returned."""
    out = tuple(out)
    _group("class_gather_group", classes, out,
           lambda b: class_gather_group_plain(b, rows_pad, n_cols, out),
           class_gather, rows_pad, n_cols)
    return out


def class_gather_keys_group(classes, rows_pad: int, n_cols: int, shift: int,
                            out: torch.Tensor) -> torch.Tensor:
    """P4 over a dispatch group: the packed keys ``(row << shift) | col`` of
    each of ``classes`` written into its column span of ``out``."""
    sentinel = (rows_pad << shift) | n_cols
    if not 0 <= shift <= 31 or not 0 <= sentinel <= INT32_MAX:
        raise ValueError(
            f"class_gather_keys: rows_pad {rows_pad} and n_cols {n_cols} do "
            f"not pack into an int32 key with shift {shift}"
        )
    _group("class_gather_keys_group", classes, (out,),
           lambda b: class_gather_keys_group_plain(b, rows_pad, n_cols, shift, out),
           class_gather_keys, rows_pad, n_cols, shift, sentinel)
    return out


def _fresh(table, pos, n: int) -> tuple[torch.Tensor, ...]:
    shape = (pos.shape[0], pos.shape[1] * table.shape[1])
    return tuple(torch.empty(shape, dtype=torch.int32, device=table.device)
                 for _ in range(n))


def class_gather(
    table: torch.Tensor,
    pos: torch.Tensor,
    rows: torch.Tensor,
    rows_pad: int,
    n_cols: int,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
    col0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """P3 for one class: the ``(row, col)`` streams as fresh ``[g, pad*w]``
    tensors, or written into columns ``col0 : col0 + pad*w`` of ``out =
    (rows_out, cols_out)``, which are then returned."""
    _check("class_gather", table, pos, rows, out or (), col0)
    if out is None:
        out, col0 = _fresh(table, pos, 2), 0
    return class_gather_group([(table, pos, rows, col0)], rows_pad, n_cols, out)


class_gather.launches = 0


def class_gather_keys(
    table: torch.Tensor,
    pos: torch.Tensor,
    rows: torch.Tensor,
    rows_pad: int,
    n_cols: int,
    shift: int,
    out: torch.Tensor | None = None,
    col0: int = 0,
) -> torch.Tensor:
    """P4 for one class: the packed key stream ``(row << shift) | col``,
    fresh or written into columns ``col0 : col0 + pad*w`` of ``out``."""
    _check("class_gather_keys", table, pos, rows, () if out is None else (out,), col0)
    if out is None:
        (out,), col0 = _fresh(table, pos, 1), 0
    return class_gather_keys_group(
        [(table, pos, rows, col0)], rows_pad, n_cols, shift, out)


class_gather_keys.launches = 0
