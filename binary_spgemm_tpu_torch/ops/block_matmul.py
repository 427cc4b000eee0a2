"""Grouped block matmul-accumulate: the blocked route's hot loop.

K3 :func:`grouped_block_matmul` is a kernel written by hand for Hopper
(``csrc/block_matmul.cu``) and replaces
``binary_spgemm_tpu/ops/pallas_bsr.py::grouped_block_matmul``: for every pair
``i`` (sorted by output block ``seg[i]``) it adds the tile product
``A[ka[i]] @ B[kb[i]]`` into ``out[seg[i]]``, bf16 tiles with f32 counts.
The values are 0/1 and each count is at most ``b`` times the pairs of a
block, far below 2^24, so the counts are exact and ``count > 0`` is the OR.

The wrapper launches the kernel for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it computes the plain PyTorch version
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

import torch

__all__ = ["MAX_BLOCK", "grouped_block_matmul", "grouped_block_matmul_plain"]

# Largest tile side the kernel takes: two padded 128 x 128 bf16 tiles fill
# 68 KB of one thread block's shared memory.
MAX_BLOCK = 128

_SIG = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _fn():
    from .._build import load

    fn = load("block_matmul").grouped_block_matmul
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


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
    if a_blocks.device.type == "cpu":
        return grouped_block_matmul_plain(
            seg, ka, kb, first, a_blocks, b_blocks, n_out=n_out
        )
    n_out = int(n_out)
    out = torch.empty((n_out, b, b), dtype=torch.float32, device=a_blocks.device)
    if n_out == 0:
        return out
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _fn()(
            seg.data_ptr(), ka.data_ptr(), kb.data_ptr(), int(seg.shape[0]),
            a_blocks.data_ptr(), b_blocks.data_ptr(),
            int(a_blocks.shape[0]), int(b_blocks.shape[0]),
            out.data_ptr(), n_out, b, stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_block_matmul launch failed: cudaError {err}")
    grouped_block_matmul.launches += 1
    return out


grouped_block_matmul.launches = 0
