"""Grouped block matmul-accumulate: the blocked route's hot loop.

K3 :func:`grouped_block_matmul` is a kernel written by hand for Hopper
(``csrc/block_matmul.cu``) and replaces
``binary_spgemm_tpu/ops/pallas_bsr.py::grouped_block_matmul``: for every pair
``i`` (sorted by output block ``seg[i]``) it adds the tile product
``A[ka[i]] @ B[kb[i]]`` into ``out[seg[i]]``, bf16 tiles with f32 counts.
The values are 0/1 and each count is at most ``b`` times the pairs of a
block, far below 2^24, so the counts are exact and ``count > 0`` is the OR.

Two kernels compute it, and :func:`k3_variant` picks one from the tile side
and the operands' alignment alone: ``"pipe"`` (a persistent kernel that walks
the output blocks with an asynchronous ring of tiles in shared memory) takes
every ``b`` that is a multiple of 8 from 8 to 128 when both tile arrays are
16-byte aligned; ``"simple"`` (one block per output block, synchronous tile
loads) takes every other ``b`` from 1 to 128.  The pipe kernel runs on
:func:`k3_grid` blocks, at most as many as the card holds at once.

The wrapper launches the kernel for CUDA tensors and counts the launch in its
``launches`` attribute, and by kernel in ``launches_by_variant``; for CPU
tensors it computes the plain PyTorch version
(:func:`grouped_block_matmul_plain`) instead.  Tensors on another device or on
mixed devices, tiles that are not contiguous bf16 ``[n, b, b]`` with
``1 <= b <= 128``, and pair arrays that are not contiguous 1-D int32 of one
length raise — there is no fallback to ``torch.bmm`` on the card.

Every output block is written, a block with no pair as zeros.  In the TPU
kernel a block no pair visits is left unspecified (the scratch block when the
pair plan has no padded tail), so comparisons with it cover the visited
blocks only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "MAX_BLOCK",
    "grouped_block_matmul",
    "grouped_block_matmul_plain",
    "k3_grid",
    "k3_variant",
]

# Largest tile side the kernels take: the pipe kernel's two ring stages of
# padded 128 x 128 bf16 A and B tiles fill 136 KB of one thread block's
# shared memory.
MAX_BLOCK = 128

_PLAN_SIG = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
]
_SIG = {
    "grouped_block_matmul": [*_PLAN_SIG, ctypes.c_void_p],
    # ... then the persistent grid's block count, then the stream
    "grouped_block_matmul_pipe": [*_PLAN_SIG, ctypes.c_int, ctypes.c_void_p],
    "grouped_block_matmul_pipe_per_sm": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}
# K3's C entry point for each variant
_K3_ENTRY = {"pipe": "grouped_block_matmul_pipe", "simple": "grouped_block_matmul"}


def _fn(name: str):
    from .._build import load

    fn = getattr(load("block_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIG[name]
        fn.restype = ctypes.c_int
    return fn


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def k3_variant(b: int, aligned: bool) -> str:
    """The K3 kernel for tile side ``b``: ``"pipe"`` for a multiple of 8
    from 8 to 128 when both tile arrays are 16-byte ``aligned`` (its copies
    move 16 bytes of a tile row at a time), else ``"simple"``."""
    return "pipe" if aligned and b % 8 == 0 and 8 <= b <= MAX_BLOCK else "simple"


def k3_grid(n_out: int, sms: int, per_sm: int) -> int:
    """Blocks of the pipe kernel's persistent grid: one for each output
    block, but no more than the card's ``sms`` SMs hold at once at
    ``per_sm`` blocks each.  Block ``c`` walks the output blocks ``c``,
    ``c + grid``, ``c + 2 grid``, ..."""
    if n_out < 1 or sms < 1 or per_sm < 1:
        raise ValueError(
            f"k3_grid: n_out {n_out}, sms {sms} and per_sm {per_sm} must be >= 1"
        )
    return min(n_out, sms * per_sm)


@functools.lru_cache(maxsize=None)
def _pipe_occupancy(device_index: int, b: int) -> tuple[int, int]:
    """The card's SM count and the pipe kernel's blocks per SM at tile side
    ``b``; asked once per device and ``b``."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _fn("grouped_block_matmul_pipe_per_sm")(b, ctypes.byref(per_sm))
    if err != 0 or per_sm.value < 1:
        raise RuntimeError(
            f"grouped_block_matmul: the pipe kernel fits no block on an SM at "
            f"b = {b} (cudaError {err}, {per_sm.value} blocks per SM)"
        )
    return sms, per_sm.value


def _check(seg, ka, kb, first, a_blocks, b_blocks, n_out) -> int:
    """Validate the arguments; return the tile side ``b``."""
    for name, t in (("seg", seg), ("ka", ka), ("kb", kb), ("first", first)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"grouped_block_matmul: {name} must be a contiguous 1-D int32 "
                f"tensor, got {t.dtype} {tuple(t.shape)}"
            )
        if t.shape != seg.shape:
            raise ValueError(
                f"grouped_block_matmul: {name} has {t.shape[0]} pairs, "
                f"seg has {seg.shape[0]}"
            )
    for name, t in (("a_blocks", a_blocks), ("b_blocks", b_blocks)):
        if (
            t.dtype != torch.bfloat16
            or t.dim() != 3
            or t.shape[1] != t.shape[2]
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"grouped_block_matmul: {name} must be contiguous bf16 "
                f"[n, b, b], got {t.dtype} {tuple(t.shape)} "
                f"contiguous={t.is_contiguous()}"
            )
    b = int(a_blocks.shape[-1])
    if b_blocks.shape[-1] != b:
        raise ValueError(
            f"grouped_block_matmul: tile sides differ ({b} and "
            f"{b_blocks.shape[-1]})"
        )
    if not 1 <= b <= MAX_BLOCK:
        raise ValueError(
            f"grouped_block_matmul: tile side {b} outside [1, {MAX_BLOCK}] "
            "(the kernel's shared-memory limit)"
        )
    if int(n_out) < 0:
        raise ValueError(f"grouped_block_matmul: n_out {n_out} < 0")
    devices = {t.device for t in (seg, ka, kb, first, a_blocks, b_blocks)}
    if len(devices) != 1:
        raise ValueError(
            f"grouped_block_matmul: tensors on several devices {devices}"
        )
    if a_blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"grouped_block_matmul: unsupported device {a_blocks.device}"
        )
    return b


def grouped_block_matmul_plain(seg, ka, kb, first, a_blocks, b_blocks, *, n_out):
    """Plain PyTorch version of K3: gather the pairs' tiles, one f32
    ``torch.bmm``, then ``index_add_`` into zeros.  As in the kernel, pairs
    with ``seg`` at or past ``n_out`` visit no output block and pairs with an
    out-of-range ``ka`` or ``kb`` contribute nothing (torch gathers and
    scatters raise where JAX drops, so such pairs are masked out first).
    ``first`` is implied by the sorted ``seg`` and kept for the signature."""
    b = a_blocks.shape[-1]
    out = torch.zeros(
        (int(n_out), b, b), dtype=torch.float32, device=a_blocks.device
    )
    keep = (
        (seg < int(n_out))
        & (ka >= 0) & (ka < a_blocks.shape[0])
        & (kb >= 0) & (kb < b_blocks.shape[0])
    )
    seg, ka, kb = seg[keep], ka[keep], kb[keep]
    prod = torch.bmm(
        torch.index_select(a_blocks, 0, ka).float(),
        torch.index_select(b_blocks, 0, kb).float(),
    )
    return out.index_add_(0, seg, prod)


def grouped_block_matmul(seg, ka, kb, first, a_blocks, b_blocks, *, n_out):
    """f32 ``[n_out, b, b]`` per-output-block pair-product counts (K3).

    ``seg``/``ka``/``kb``/``first`` are int32 ``[npairs]``, sorted by
    ``seg``; ``a_blocks``/``b_blocks`` bf16 ``[n, b, b]``.  The pair indices
    are not range-checked (on the card that would need a host sync): a pair
    whose ``ka`` or ``kb`` is out of range contributes nothing."""
    b = _check(seg, ka, kb, first, a_blocks, b_blocks, n_out)
    variant = k3_variant(b, _aligned16(a_blocks) and _aligned16(b_blocks))
    return _grouped_block_matmul_variant(
        seg, ka, kb, first, a_blocks, b_blocks, n_out=n_out, variant=variant
    )


def _grouped_block_matmul_variant(
    seg, ka, kb, first, a_blocks, b_blocks, *, n_out, variant
):
    """K3 through the named kernel: what :func:`grouped_block_matmul` runs,
    and a way to time one kernel where the other one takes the arguments.
    Raises where the named kernel cannot take them; never falls back."""
    b = _check(seg, ka, kb, first, a_blocks, b_blocks, n_out)
    if variant not in _K3_ENTRY:
        raise ValueError(f"unknown K3 variant {variant!r}")
    if variant == "pipe" and k3_variant(
        b, _aligned16(a_blocks) and _aligned16(b_blocks)
    ) != "pipe":
        raise ValueError(
            "K3 variant 'pipe' takes tile sides that are multiples of 8 from 8 "
            f"to {MAX_BLOCK} in 16-byte aligned tile arrays, got b = {b}, "
            f"aligned {_aligned16(a_blocks)} and {_aligned16(b_blocks)}"
        )
    if a_blocks.device.type == "cpu":
        return grouped_block_matmul_plain(
            seg, ka, kb, first, a_blocks, b_blocks, n_out=n_out
        )
    n_out = int(n_out)
    out = torch.empty((n_out, b, b), dtype=torch.float32, device=a_blocks.device)
    if n_out == 0:
        return out
    args = [
        seg.data_ptr(), ka.data_ptr(), kb.data_ptr(), int(seg.shape[0]),
        a_blocks.data_ptr(), b_blocks.data_ptr(),
        int(a_blocks.shape[0]), int(b_blocks.shape[0]),
        out.data_ptr(), n_out, b,
    ]
    if variant == "pipe":
        args.append(k3_grid(n_out, *_pipe_occupancy(out.device.index, b)))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _fn(_K3_ENTRY[variant])(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"grouped_block_matmul ({variant}) launch failed: cudaError {err}"
        )
    grouped_block_matmul.launches += 1
    grouped_block_matmul.launches_by_variant[variant] += 1
    return out


grouped_block_matmul.launches = 0
grouped_block_matmul.launches_by_variant = {"pipe": 0, "simple": 0}
