"""Row-wise sorts of int32 ``[k, L]`` arrays: the batched engine's sort step.

Two kernels written by hand for Hopper live in ``csrc/bitonic.cu``:

* K1 :func:`bitonic_sort_rows` — each row sorted ascending (replaces
  ``binary_spgemm_tpu/ops/bitonic.py::bitonic_sort_rows``), by one of three
  kernels that :func:`k1_variant` picks from the row length alone:
  ``"warp"`` (one warp a row, registers and shuffles only, 1 <= L <= 128),
  ``"reg"`` (registers and warp shuffles, 129 <= L <= 4096) or ``"wide"``
  (one row a block in registers, shuffles and shared memory across warps,
  the padding left untouched, 4097 <= L <= 32768);
* K2 :func:`fused_sort_compress` — sort, left-neighbour dedup with
  demote-to-``INT32_MAX`` of everything at or above ``limit``, sort again, in
  one pass over each row (replaces ``fused_sort_compress`` there): K1's
  kernel for the row length with a compaction epilogue in place of the
  second sort, since the second sort only packs the kept entries, already
  ascending, to the front of the row;
* P1/P2 :func:`bitonic_network_rows` — the bitonic network over rows of a
  power-of-two length, run from a given merge size on: from the first, a
  sort (replaces ``benchmarks/pallas_sort.py::make_bitonic``); from merge
  ``2w``, the shortcut for streams of w-aligned sorted runs of alternating
  direction (replaces ``benchmarks/ab_wruns.py::make_kernel``).  K1's
  kernels run it, chosen by the row length as :func:`k1_variant` chooses.

``"smem"`` names the earlier designs of K1 and K2 (the whole network in
shared memory), kept as the yardstick the others are timed against:
``_sort_rows_variant(x, "smem")`` and ``_fused_sort_compress_variant(x,
limit, "smem")`` launch them, and no path does.

Each wrapper launches its kernel for a CUDA tensor and counts the launch in
its ``launches`` attribute; for a CPU tensor it computes the plain PyTorch
version (``*_plain`` below) instead.  Any other device, a dtype other than
int32, a tensor that is not 2-D and contiguous, or a row longer than
:data:`MAX_L` raises — there is no fallback to ``torch.sort`` on the card.
:func:`sort_rows`, the engines' sort step, picks K1 or ``torch.sort`` by the
row length alone, as the JAX package picks its kernel or ``lax.sort``.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.trace import count

__all__ = [
    "MAX_L",
    "bitonic_network_rows",
    "bitonic_network_rows_plain",
    "bitonic_sort_rows",
    "bitonic_sort_rows_plain",
    "fused_sort_compress",
    "fused_sort_compress_plain",
    "k1_variant",
    "sort_rows",
    "wide_block",
]

INT32_MAX = (1 << 31) - 1

# Longest row the kernels take: a row is padded to the next power of two in
# one block's shared memory, and 2^15 int32 slots (128 KB) is the largest
# power of two under the 227 KB a block may use.
MAX_L = 1 << 15

# Row lengths K1's warp kernel takes: rows padded to P = 2^0 ... 2^7, one warp
# holding a row (32 / P rows below P = 32) in registers.
WARP_MAX_L = 1 << 7
# Row lengths K1's register kernel takes: rows padded to P = 2^8 ... 2^12, one
# block of 512 threads holding 8 slots each.
REG_MIN_L, REG_MAX_L = WARP_MAX_L + 1, 1 << 12
# Row lengths K1's wide kernel takes: rows padded to P = 2^13 ... 2^15, one row a
# block.
WIDE_MIN_L, WIDE_MAX_L = REG_MAX_L + 1, MAX_L
_VARIANT_L = {"warp": (1, WARP_MAX_L), "reg": (REG_MIN_L, REG_MAX_L),
              "wide": (WIDE_MIN_L, WIDE_MAX_L)}
# rows up to this length take the wide kernel's 512 x 16 block at P = 8192
# (its idle warps then cover more of the padding), longer ones 256 x 32
WIDE_SHORT_L = 4608

# K1's and K2's C entry point for each variant, and the network's (P1/P2)
_K1_ENTRY = {"warp": "bitonic_sort_rows_warp", "reg": "bitonic_sort_rows_reg",
             "wide": "bitonic_sort_rows_wide", "smem": "bitonic_sort_rows"}
_K2_ENTRY = {"warp": "fused_sort_compress_warp", "reg": "fused_sort_compress_reg",
             "wide": "fused_sort_compress_wide", "smem": "fused_sort_compress_smem"}
_NETWORK_ENTRY = {"warp": "bitonic_network_rows_warp", "reg": "bitonic_network_rows_reg",
                  "wide": "bitonic_network_rows_wide"}

_SORT_SIG = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p,
]
# (x, out, k, L, one int, stream): the int is log2 of the slots a thread holds
# (K1 wide), the first merge (the network) or the limit (K2); two ints: the
# network's or K2's, then the wide kernel's slots a thread
_INT_SIG = [*_SORT_SIG[:4], ctypes.c_int, ctypes.c_void_p]
_INT2_SIG = [*_SORT_SIG[:4], ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SIG = {
    "bitonic_sort_rows": _SORT_SIG,
    "bitonic_sort_rows_warp": _SORT_SIG,
    "bitonic_sort_rows_reg": _SORT_SIG,
    "bitonic_sort_rows_wide": _INT_SIG,
    "bitonic_network_rows": _INT_SIG,
    "bitonic_network_rows_warp": _INT_SIG,
    "bitonic_network_rows_reg": _INT_SIG,
    "bitonic_network_rows_wide": _INT2_SIG,
    "fused_sort_compress_smem": _INT_SIG,
    "fused_sort_compress_warp": _INT_SIG,
    "fused_sort_compress_reg": _INT_SIG,
    "fused_sort_compress_wide": _INT2_SIG,
}


def _fn(name: str):
    from .._build import load

    fn = getattr(load("bitonic"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIG[name]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"{what} takes a contiguous 2-D int32 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if x.shape[1] > MAX_L:
        raise ValueError(
            f"{what}: row length {x.shape[1]} exceeds the kernel's "
            f"shared-memory limit {MAX_L}"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _launch(name: str, x: torch.Tensor, *extra: int) -> torch.Tensor:
    out = torch.empty_like(x)
    k, L = x.shape
    if k == 0 or L == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(name)(x.data_ptr(), out.data_ptr(), k, L, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def bitonic_sort_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    return torch.sort(x, dim=1).values


def k1_variant(L: int) -> str:
    """The K1 kernel that sorts rows of length ``L`` (and K2's): ``"warp"``
    for ``1 <= L <= WARP_MAX_L``, ``"reg"`` for ``REG_MIN_L <= L <=
    REG_MAX_L``, ``"wide"`` for ``WIDE_MIN_L <= L <= WIDE_MAX_L``, else
    ``"smem"`` (rows no kernel sorts: empty ones, launched by nothing, and
    rows past :data:`MAX_L`, which the wrappers refuse)."""
    for variant, (lo, hi) in _VARIANT_L.items():
        if lo <= L <= hi:
            return variant
    return "smem"


def wide_block(L: int, sort: bool = True) -> tuple[int, int]:
    """(threads, slots a thread) of K1's wide kernel for rows of ``L``: the
    one place that picks them, from the times of
    ``benchmarks/k1_wide_shapes.py``; the wrappers pass the choice to
    ``csrc/bitonic.cu::launch_wide``, which refuses a shape it does not
    build.  ``sort=False`` for the network form (P1/P2)."""
    if not WIDE_MIN_L <= L <= WIDE_MAX_L:
        raise ValueError(
            f"K1's wide kernel takes rows of {WIDE_MIN_L} to {WIDE_MAX_L}, got {L}"
        )
    P = 1 << (L - 1).bit_length()
    n = {8192: 16 if sort and L <= WIDE_SHORT_L else 32, 16384: 32 if sort else 16,
         32768: 32 if sort else 64}[P]
    return P // n, n


def _log2(n: int) -> int:
    return n.bit_length() - 1


def bitonic_sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of int32 ``[k, L]`` ``x`` ascending (K1)."""
    _check(x, "bitonic_sort_rows")
    return _sort_rows_variant(x, k1_variant(x.shape[1]))


def _sort_rows_variant(x: torch.Tensor, variant: str) -> torch.Tensor:
    """K1 through the named kernel: what :func:`bitonic_sort_rows` runs, and
    a way to time one variant at a length another one takes (``"smem"``
    takes every length)."""
    _check(x, "bitonic_sort_rows")
    if variant not in _K1_ENTRY:
        raise ValueError(f"unknown K1 variant {variant!r}")
    L = x.shape[1]
    lo, hi = _VARIANT_L.get(variant, (0, MAX_L))
    if not lo <= L <= hi:
        raise ValueError(f"K1 variant {variant!r} takes rows of {lo} to {hi}, got {L}")
    if x.device.type == "cpu":
        return bitonic_sort_rows_plain(x)
    extra = (_log2(wide_block(L)[1]),) if variant == "wide" else ()
    out = _launch(_K1_ENTRY[variant], x, *extra)
    if x.numel():
        bitonic_sort_rows.launches += 1
        bitonic_sort_rows.launches_by_variant[variant] += 1
    return out


bitonic_sort_rows.launches = 0
bitonic_sort_rows.launches_by_variant = {"warp": 0, "reg": 0, "wide": 0, "smem": 0}


def fused_sort_compress_plain(x: torch.Tensor, limit: int) -> torch.Tensor:
    """Plain PyTorch version of K2: sort, keep each entry that differs from
    its left neighbour (position 0 always) and lies below ``limit``, demote
    the rest to ``INT32_MAX``, sort again."""
    s = torch.sort(x, dim=1).values
    keep = s < limit
    keep[:, 1:] &= s[:, 1:] != s[:, :-1]
    return torch.sort(torch.where(keep, s, INT32_MAX), dim=1).values


def fused_sort_compress(x: torch.Tensor, limit: int) -> torch.Tensor:
    """K2: the packed sort-dedup-sort step as one kernel, K1's kernel for
    the row length (:func:`k1_variant`) with a compaction epilogue.  Returns
    the compacted sorted keys (valid ascending prefix, ``INT32_MAX`` fill);
    the per-row valid count is ``(out < limit).sum(1)``."""
    _check(x, "fused_sort_compress")
    return _fused_sort_compress_variant(x, limit, k1_variant(x.shape[1]))


def _fused_sort_compress_variant(x: torch.Tensor, limit: int, variant: str) -> torch.Tensor:
    """K2 through the named kernel: what :func:`fused_sort_compress` runs,
    and a way to time the shared-memory kernel (``"smem"``, every length)
    against it."""
    _check(x, "fused_sort_compress")
    limit = int(limit)
    if not -(1 << 31) <= limit <= INT32_MAX:
        raise ValueError(f"fused_sort_compress: limit {limit} is not int32")
    if variant not in _K2_ENTRY:
        raise ValueError(f"unknown K2 variant {variant!r}")
    L = x.shape[1]
    lo, hi = _VARIANT_L.get(variant, (0, MAX_L))
    if not lo <= L <= hi:
        raise ValueError(f"K2 variant {variant!r} takes rows of {lo} to {hi}, got {L}")
    if x.device.type == "cpu":
        return fused_sort_compress_plain(x, limit)
    extra = (_log2(wide_block(L)[1]),) if variant == "wide" else ()
    out = _launch(_K2_ENTRY[variant], x, limit, *extra)
    if x.numel():
        fused_sort_compress.launches += 1
        fused_sort_compress.launches_by_variant[variant] += 1
    return out


fused_sort_compress.launches = 0
fused_sort_compress.launches_by_variant = {"warp": 0, "reg": 0, "wide": 0, "smem": 0}


def _stages(L: int) -> list[tuple[int, int]]:
    """Bitonic network (kk, j) stage list for pow2 length L."""
    out = []
    kk = 2
    while kk <= L:
        j = kk // 2
        while j >= 1:
            out.append((kk, j))
            j //= 2
        kk *= 2
    return out


def _pick_block(k: int, L: int) -> int | None:
    """The JAX kernels' row block (rows a grid step) for ``k`` rows of
    ``L``, verbatim; its grid leaves rows past a multiple of it undefined.
    The port's kernels take any k; this says at which k the two agree."""
    cap = 128 if L <= 2048 else 32  # measured-safe VMEM block budget
    for b in (128, 64, 32, 16, 8):
        if b <= cap and k % b == 0:
            return b
    return None


def bitonic_network_rows_plain(x: torch.Tensor, min_kk: int = 2) -> torch.Tensor:
    """Plain PyTorch version of P1/P2: the stages ``(kk, j)`` of
    :func:`_stages` with ``kk >= min_kk``, each as the JAX kernels run it,
    two ``torch.roll``s and ``torch.where``s.  Not ``torch.sort``: from a
    later first merge the output is sorted only on the runs it assumes."""
    L = x.shape[1]
    i = torch.arange(L, dtype=torch.int32, device=x.device)
    out = x
    for kk, j in _stages(L):
        if kk < min_kk:
            continue
        is_lo = (i & j) == 0
        take_min = is_lo == ((i & kk) == 0)
        partner = torch.where(is_lo, torch.roll(out, -j, 1), torch.roll(out, j, 1))
        out = torch.where(take_min, torch.minimum(out, partner),
                          torch.maximum(out, partner))
    return x.clone() if out is x else out


def _first_merge(min_kk: int, L: int) -> int:
    """log2 of the first merge size that the network over rows of ``L`` runs
    for ``min_kk``: the kernels' ``log_kk0``, ``log2(L) + 1`` when none runs."""
    return min((max(int(min_kk), 2) - 1).bit_length(), L.bit_length())


def bitonic_network_rows(x: torch.Tensor, min_kk: int = 2) -> torch.Tensor:
    """P1/P2: the ascending bitonic network over each row of int32 ``[k, L]``
    ``x`` (L a power of two), running only the stages whose merge size
    ``kk >= min_kk``.  ``min_kk <= 2`` sorts every row (P1); ``min_kk = 2w``
    sorts rows made of w-aligned sorted runs whose direction alternates
    (ascending where ``(start & w) == 0``) and gives the partial network's
    permutation on other rows (P2); ``min_kk > L`` runs no stage (a copy)."""
    _check(x, "bitonic_network_rows")
    L = x.shape[1]
    if L < 1 or L & (L - 1):
        raise ValueError(f"bitonic_network_rows: row length {L} is not a power of two")
    if x.device.type == "cpu":
        return bitonic_network_rows_plain(x, min_kk)
    variant = k1_variant(L)
    extra = (_log2(wide_block(L, sort=False)[1]),) if variant == "wide" else ()
    out = _launch(_NETWORK_ENTRY[variant], x, _first_merge(min_kk, L), *extra)
    if x.numel():
        bitonic_network_rows.launches += 1
    return out


bitonic_network_rows.launches = 0


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Ascending value sort of each row of int32 ``[k, L]`` ``x`` — the
    counterpart of ``jax.lax.sort(x, dimension=1, is_stable=False)`` (no
    payload, so stability is moot).  The route is a function of ``L`` alone,
    as the JAX package's is: rows up to :data:`MAX_L` through K1, longer rows
    through ``torch.sort``, the op for the XLA sort the JAX package runs
    outside its kernel's window.  ``sort_rows.routes`` counts the calls by
    route, on every device; while tracing is on, the slots go to the
    ``sort.slots`` count."""
    count("sort.slots", x.numel())
    if x.dim() == 2 and x.shape[1] > MAX_L:
        sort_rows.routes["torch_sort"] += 1
        return torch.sort(x, dim=1).values
    sort_rows.routes["k1"] += 1
    return bitonic_sort_rows(x)


sort_rows.routes = {"k1": 0, "torch_sort": 0}
