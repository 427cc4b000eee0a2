"""Class-table row gathers: the sliced-ELL expansion of one width class.

Two kernels written by hand for Hopper live in ``csrc/gather.cu``:

* P3 :func:`class_gather` — for one width class over the ``g`` chunks or bins
  of a dispatch group, the ``(row, col)`` candidate streams ``[g, pad*w]``:
  slot ``(i, e*w + j)`` holds ``(rows[i, e], table[pos[i, e], j])``, or
  ``(rows_pad, n_cols)`` where the column is the table's sentinel or the row
  id is not below ``rows_pad`` (replaces
  ``benchmarks/pallas_gather.py::pallas_gather``);
* P4 :func:`class_gather_keys` — the same gather fused with the key pack,
  ``(row << shift) | col`` and the sentinel key ``(rows_pad << shift) |
  n_cols`` (replaces ``pallas_gather_keys`` there).

Positions follow JAX's indexing, which the JAX package's expansion relies on:
a negative position counts from the end, then every position is clamped to
``[0, nc - 1]``.

Each wrapper writes either a fresh ``[g, pad*w]`` stream or, given ``out``,
the column span ``[col0, col0 + pad*w)`` of the caller's wider group stream.
For a CUDA tensor it launches its kernel and counts the launch in its
``launches`` attribute (an empty group launches nothing); for a CPU tensor it
computes the plain PyTorch version (``*_plain`` below).  Anything the kernel
does not take raises: there is no fallback to the plain version on the card.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "class_gather",
    "class_gather_keys",
    "class_gather_keys_plain",
    "class_gather_plain",
]

INT32_MAX = (1 << 31) - 1

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_HEAD = [_PTR, _I32, _I32, _PTR, _I64, _PTR, _I64, _I32, _I32]
_SIG = {
    "class_gather": _HEAD + [_PTR, _PTR, _I64, _I64, _I32, _I32, _PTR],
    "class_gather_keys": _HEAD + [_PTR, _I64, _I64, _I32, _I32, _I32, _I32, _PTR],
}


def _fn(name: str):
    from .._build import load

    fn = getattr(load("gather"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIG[name]
        fn.restype = ctypes.c_int
    return fn


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
    """Plain PyTorch version of P3: indexing plus ``torch.where``."""
    shape = (pos.shape[0], pos.shape[1] * table.shape[1])
    r, cols, valid = _gathered(table, pos, rows, rows_pad, n_cols)
    return (torch.where(valid, r, rows_pad).reshape(shape),
            torch.where(valid, cols, n_cols).reshape(shape))


def class_gather_keys_plain(
    table: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
    rows_pad: int, n_cols: int, shift: int,
) -> torch.Tensor:
    """Plain PyTorch version of P4."""
    shape = (pos.shape[0], pos.shape[1] * table.shape[1])
    r, cols, valid = _gathered(table, pos, rows, rows_pad, n_cols)
    sentinel = (rows_pad << shift) | n_cols
    return torch.where(valid, (r << shift) | cols, sentinel).reshape(shape)


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
    return span


def _launch(name, table, pos, rows, outs, col0: int, *tail: int) -> None:
    g, pad = pos.shape
    nc, w = table.shape
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _fn(name)(
            table.data_ptr(), nc, w, pos.data_ptr(), pos.stride(0),
            rows.data_ptr(), rows.stride(0), g, pad,
            *(t.data_ptr() for t in outs), outs[0].stride(0), col0, *tail,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def class_gather(
    table: torch.Tensor,
    pos: torch.Tensor,
    rows: torch.Tensor,
    rows_pad: int,
    n_cols: int,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
    col0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """P3: the ``(row, col)`` streams of one gathered width class, as fresh
    ``[g, pad*w]`` tensors, or written into columns ``col0 : col0 + pad*w``
    of ``out = (rows_out, cols_out)``, which are then returned."""
    span = _check("class_gather", table, pos, rows, out or (), col0)
    if table.device.type == "cpu":
        r, c = class_gather_plain(table, pos, rows, rows_pad, n_cols)
        if out is None:
            return r, c
        out[0][:, col0 : col0 + span] = r
        out[1][:, col0 : col0 + span] = c
        return out
    if out is None:
        out = tuple(
            torch.empty((pos.shape[0], span), dtype=torch.int32, device=table.device)
            for _ in range(2)
        )
        col0 = 0
    if pos.numel():
        _launch("class_gather", table, pos, rows, out, col0, rows_pad, n_cols)
        class_gather.launches += 1
    return out


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
    """P4: the packed key stream ``(row << shift) | col`` of one gathered
    width class, fresh or written into columns ``col0 : col0 + pad*w`` of
    ``out``."""
    sentinel = (rows_pad << shift) | n_cols
    if not 0 <= shift <= 31 or not 0 <= sentinel <= INT32_MAX:
        raise ValueError(
            f"class_gather_keys: rows_pad {rows_pad} and n_cols {n_cols} do "
            f"not pack into an int32 key with shift {shift}"
        )
    span = _check(
        "class_gather_keys", table, pos, rows, () if out is None else (out,), col0
    )
    if table.device.type == "cpu":
        key = class_gather_keys_plain(table, pos, rows, rows_pad, n_cols, shift)
        if out is None:
            return key
        out[:, col0 : col0 + span] = key
        return out
    if out is None:
        out = torch.empty((pos.shape[0], span), dtype=torch.int32, device=table.device)
        col0 = 0
    if pos.numel():
        _launch("class_gather_keys", table, pos, rows, (out,), col0,
                rows_pad, n_cols, shift, sentinel)
        class_gather_keys.launches += 1
    return out


class_gather_keys.launches = 0
