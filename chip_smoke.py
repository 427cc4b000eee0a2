#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (binary_spgemm_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, each reported on its own lines; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. the build of every kernel source (``csrc/*.cu``): seconds and ptxas report;
3. K1 (bitonic_sort_rows) and K2 (fused_sort_compress) bit-equal to their
   plain PyTorch versions at the main path's shape, a power-of-two length,
   a short odd length and the longest length the kernels take;
4. the main path: C = A·A for ``BCSR.random(65536, 65536, 16.0, seed=2026)``
   through ``auto_executor`` -> ``run()`` -> ``assemble()``, bit-exact against
   scipy, with the launch counts set to 0 just before ``auto_executor`` and
   read just after ``assemble()`` (K1 must have run twice per dispatch group);
5. K2 on the main path's real key streams, equal to K1 twice plus the dedup;
6. times from CUDA events: ``run()``, ``run()`` + ``assemble()``, each kernel,
   its plain version and ``torch.sort`` at the main path's shape; the host
   clock's split of ``assemble()`` into pull and host assembly; a
   ``torch.profiler`` breakdown of ``run()`` with the device's idle share;
7. a ``{"kernels": [...]}`` line, then, last, the ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N, D, SEED = 65536, 16.0, 2026
EXPECTED_NNZ = 16_703_465
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12  # H100 SXM peak outside the tensor cores (FP32 rate)
INT32_MAX = (1 << 31) - 1
INT32_MIN = -(1 << 31)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def event_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sort_bound_ms(numel: int, length: int, sorts: int = 1) -> tuple[float, str]:
    """Least time for ``sorts`` row sorts of ``numel`` int32 keys in rows of
    ``length``: one read and one write over the memory rate, against
    ceil(log2 L) compares per key and sort over the peak rate."""
    bytes_ms = 2 * 4 * numel / HBM_BYTES_PER_S * 1e3
    ops_ms = (sorts * numel * max(1, (length - 1).bit_length())
              / INT32_OPS_PER_S * 1e3)
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def profile_run(torch, run, reps: int = 3) -> None:
    """Device time of ``run()`` by kernel name (torch.profiler), and the
    device's idle share of the wall time between the first launch and the
    last completion."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / reps
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # host ops repeat their kernels' time
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / reps / 1e3, e.count / reps, e.key))
    if not rows:
        print("profile of run(): the profiler recorded no device time "
              "(busy share not measured)")
        return
    busy = sum(r[0] for r in rows)
    print(f"profile of run() (torch.profiler, {reps} runs): wall {wall:.4f} ms, "
          f"device busy {busy:.4f} ms, idle share {1 - busy / wall:.3f}")
    for ms, count, name in sorted(rows, reverse=True)[:10]:
        print(f"  {ms:8.4f} ms  {ms / busy:6.1%}  x{count:g}  {name[:90]}")


def run_smoke() -> dict:
    import torch

    phase("1. card")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    sys.path.insert(0, ROOT)
    from binary_spgemm_tpu_torch import BCSR, _build, auto_executor
    from binary_spgemm_tpu_torch.ops import bitonic, ell
    from binary_spgemm_tpu_torch.ops.spgemm import pull_chunk_prefixes
    from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for stem, rec in sorted(_build.build_log.items()):
        print(f"{stem}: nvcc {rec['seconds']:.2f} s")
        for line in rec["ptxas"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print("  " + line.strip())
    if not _build.build_log:
        print("libraries were already built from the same sources")

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    errs = {"bitonic_sort_rows": 0, "fused_sort_compress": 0}

    phase("3. kernels against their plain versions")
    for k, L in [(1024, 3968), (512, 4096), (333, 37), (16, bitonic.MAX_L), (7, 1)]:
        x = rng.integers(0, max(L // 2, 2), (k, L)).astype(np.int32)  # duplicates
        x[0, : min(3, L)] = INT32_MAX
        x[min(1, k - 1), : min(2, L)] = INT32_MIN
        xt = torch.from_numpy(x).to(dev)
        limit = max(L // 3, 1)
        for name, got, want in (
            ("bitonic_sort_rows", bitonic.bitonic_sort_rows(xt),
             bitonic.bitonic_sort_rows_plain(xt)),
            ("fused_sort_compress", bitonic.fused_sort_compress(xt, limit),
             bitonic.fused_sort_compress_plain(xt, limit)),
        ):
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            errs[name] = max(errs[name], err)
            check(torch.equal(got, want), f"{name} differs at [{k}, {L}]")
            print(f"{name} [{k}, {L}]: bit-equal")

    phase("4. main path")
    bitonic.bitonic_sort_rows.launches = 0
    bitonic.fused_sort_compress.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = BCSR.random(N, N, D, seed=SEED)
    ex = auto_executor(a, a)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    out = ex.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    c = ex.assemble(out)
    launches = {
        "bitonic_sort_rows": bitonic.bitonic_sort_rows.launches,
        "fused_sort_compress": bitonic.fused_sort_compress.launches,
    }
    check(isinstance(ex, ell.EllSpGEMMExecutor) and ex.batched, "not batched")
    print(f"input nnz {a.nnz}; plan + stage {plan_s:.2f} s: k={ex.n_chunks} "
          f"groups={ex.n_groups}x{ex.group_size} rows_pad={ex.rows_pad} "
          f"widths={ex.widths} pads={ex.pads} sort_pad={ex.sort_pad} "
          f"out_pad={ex.out_pad}")
    print(f"peak device memory through run(): {peak / 2**20:.1f} MiB")
    print(f"launches in auto_executor -> run() -> assemble(): {launches}")
    check(launches["bitonic_sort_rows"] == 2 * ex.n_groups,
          f"K1 launched {launches['bitonic_sort_rows']} times, "
          f"expected {2 * ex.n_groups}")
    ref = spgemm_oracle(a, a)
    check(c.equals(ref), "C = A·A differs from scipy")
    check(c.nnz == EXPECTED_NNZ, f"output nnz {c.nnz} != {EXPECTED_NNZ}")
    print(f"C = A·A bit-exact against scipy: output nnz {c.nnz}")

    phase("5. K2 on the main path's key streams")
    shift = int(ex.n_cols).bit_length()
    limit = ex.rows_pad << shift
    tables = ell._unpack_tables(ex.tables_flat, ex.table_shapes)
    spans = tuple(p * w if s is None else p
                  for s, w, p in zip(ex.table_shapes, ex.widths, ex.pads))
    idx_run, nnz_run = out
    keys = []
    for row0 in ex._row0s():
        er, ep = ell._unpack_entries(
            ex.er_all, ex.ep_all, row0, ex.group_size, ex.pads, spans
        )
        key = ell._assemble_stream_2d(
            tables, er, ep, ex.group_size, ex.rows_pad, ex.n_cols,
            ex.widths, ex.pads, ex.sort_pad, shift=shift,
        )
        keys.append(key)
        s = bitonic.bitonic_sort_rows(key)
        prev = torch.cat([torch.full_like(s[:, :1], -1), s[:, :-1]], dim=1)
        keep = (s != prev) & (s < limit)
        want = bitonic.bitonic_sort_rows(torch.where(keep, s, INT32_MAX))
        got = bitonic.fused_sort_compress(key, limit)
        torch.cuda.synchronize()
        errs["fused_sort_compress"] = max(
            errs["fused_sort_compress"], int((got.long() - want.long()).abs().max())
        )
        check(torch.equal(got, want), f"K2 differs from K1+dedup, group at {row0}")
        g = slice(row0, row0 + ex.group_size)
        check(torch.equal((got < limit).sum(1, dtype=torch.int32), nnz_run[g]),
              "K2 valid counts differ from run()")
        mask = (1 << shift) - 1
        check(torch.equal(got[:, : ex.out_pad] & mask, idx_run[g]),
              "K2 columns differ from run()")
    print(f"K2 equal to K1 + dedup + K1 on all {len(keys)} group streams "
          f"{tuple(keys[0].shape)}, and to run()'s outputs")

    phase("6. times (CUDA events)")
    for _ in range(3):
        ex.run()
    torch.cuda.synchronize()
    run_ms = [event_ms(torch, ex.run, 1) for _ in range(30)]
    e2e_ms = [event_ms(torch, lambda: ex.assemble(ex.run()), 1) for _ in range(5)]
    print(f"run(): median {statistics.median(run_ms):.4f} ms, "
          f"fastest {min(run_ms):.4f} ms, slowest {max(run_ms):.4f} ms "
          f"({len(run_ms)} runs)")
    print(f"run() + assemble(): median {statistics.median(e2e_ms):.2f} ms, "
          f"fastest {min(e2e_ms):.2f} ms, slowest {max(e2e_ms):.2f} ms "
          f"({len(e2e_ms)} runs)")
    # assemble()'s two halves on the host clock: the pull of each bin's valid
    # prefix (device compaction + copy to the host), then the host assembly
    pull_ms, host_ms = [], []
    for _ in range(3):
        idx_dev, nnz_dev = ex.run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        valid = nnz_dev.cpu().numpy().astype(np.int64)
        valid[ex.n_chunks :] = 0
        parts = pull_chunk_prefixes(idx_dev, valid)
        t1 = time.perf_counter()
        check(ex._assemble_seps_batch(parts, valid).equals(c),
              "split assemble() differs")
        t2 = time.perf_counter()
        pull_ms.append((t1 - t0) * 1e3)
        host_ms.append((t2 - t1) * 1e3)
    print(f"assemble() split (host clock, median of 3): pull "
          f"{statistics.median(pull_ms):.2f} ms, host assembly "
          f"{statistics.median(host_ms):.2f} ms")

    profile_run(torch, ex.run)

    x = keys[0]
    k1 = lambda: bitonic.bitonic_sort_rows(x)
    k1_plain = lambda: bitonic.bitonic_sort_rows_plain(x)
    k1_lib = lambda: torch.sort(x, dim=1)
    k2 = lambda: bitonic.fused_sort_compress(x, limit)
    k2_plain = lambda: bitonic.fused_sort_compress_plain(x, limit)
    for fn in (k1, k1_plain, k1_lib, k2, k2_plain):
        fn()
    times: dict[str, list[float]] = {}
    order = [("k1", k1), ("k1_plain", k1_plain), ("k1_lib", k1_lib),
             ("k2", k2), ("k2_plain", k2_plain)]
    for name, fn in order + order[::-1]:  # in turns: forward, then back
        times.setdefault(name, []).append(event_ms(torch, fn, 50))
    t = {name: min(v) for name, v in times.items()}
    bound, bound_by = sort_bound_ms(x.numel(), x.shape[1])
    bound2, bound2_by = sort_bound_ms(x.numel(), x.shape[1], sorts=2)
    shape = list(x.shape)
    print(f"at {shape}: K1 {t['k1']:.4f} ms, plain {t['k1_plain']:.4f} ms, "
          f"torch.sort {t['k1_lib']:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
          f"K2 {t['k2']:.4f} ms, plain {t['k2_plain']:.4f} ms, "
          f"bound {bound2:.4f} ms ({bound2_by})")

    src = "binary_spgemm_tpu_torch/csrc/bitonic.cu"
    kernels = [
        {
            "name": "bitonic_sort_rows", "route": "cuda", "source": src,
            "replaces": "binary_spgemm_tpu/ops/bitonic.py:114",
            "launches": launches["bitonic_sort_rows"],
            "max_abs_err": errs["bitonic_sort_rows"], "ms": t["k1"],
            "plain_ms": t["k1_plain"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": t["k1_lib"], "shape": shape, "on_main_path": True,
        },
        {
            "name": "fused_sort_compress", "route": "cuda", "source": src,
            "replaces": "binary_spgemm_tpu/ops/bitonic.py:225",
            "launches": launches["fused_sort_compress"],
            "max_abs_err": errs["fused_sort_compress"], "ms": t["k2"],
            "plain_ms": t["k2_plain"], "bound_ms": bound2, "bound_by": bound2_by,
            "library_ms": None, "shape": shape, "on_main_path": False,
        },
    ]
    phase("7. kernels")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    return {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}


def main() -> int:
    try:
        device = run_smoke()
    except Exception as err:  # report the failed phase, print no result
        print(f"chip_smoke FAILED: {type(err).__name__}: {err}", file=sys.stderr)
        raise
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
