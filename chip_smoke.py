#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (binary_spgemm_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, each reported on its own lines; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. the build of every kernel source (``csrc/*.cu``): seconds and ptxas report,
   and of the native host tier (``native/mmparse.c``, ``cc -fopenmp``);
   K1's register and wide kernels, K3's pipe kernel and the P3/P4 group
   kernel must show no stack frame and no spills in any instantiation;
3. K1 (bitonic_sort_rows) and K2 (fused_sort_compress) bit-equal to their
   plain PyTorch versions at the main path's shape, a power-of-two length,
   a short odd length, the longest length the kernels take, and the lengths
   on both sides of each bound of K1's register variant (129 ... 4096) and
   of its wide variant (4097 ... 32768, with its block shapes' bounds at
   4608, 8192 and 16384), and the wide kernel at every block shape built;
4. P3 (class_gather) and P4 (class_gather_keys) ``torch.equal`` to their
   plain PyTorch versions at widths 1, 2, 3, 16, 40 and 10240, with
   out-of-range and negative positions, sentinel and out-of-range row ids,
   empty groups, column slices as inputs and a column offset into a wider
   stream; then their group entry points (``class_gather_group``,
   ``class_gather_keys_group``, one launch per dispatch group) on groups of
   widths 1 to 200, of w = 10240 between two narrow classes and of more
   classes than one launch takes (two launches), each span from an odd
   column of a stream whose row stride is not a multiple of 4, and on
   groups with no gathered class (no launch);
5. the main path: C = A·A for ``BCSR.random(65536, 65536, 16.0, seed=2026)``
   through ``auto_executor`` -> ``run()`` -> ``assemble()``, bit-exact against
   scipy, with the launch counts set to 0 just before ``auto_executor`` and
   read just after ``assemble()`` (K1 twice per dispatch group, every time as
   its register variant; P4 once per dispatch group; P3 never);
6. K2 on the main path's real key streams, equal to K1 twice plus the dedup;
7. times from CUDA events: ``run()``, ``run()`` + ``assemble()``, each kernel,
   its plain version and ``torch.sort`` at the main path's shape, with K1's
   shared-memory variant beside its register variant; K1 against
   ``torch.sort`` at three more shapes; the host clock's split of
   ``assemble()`` into pull and host assembly; a ``torch.profiler`` breakdown
   of ``run()`` with the device's idle share; P3 and P4 over one dispatch
   group's gathered classes (one launch each) beside their plain versions
   and ``torch.index_select`` per class;
8. the blocked path: C = A·A for ``BCSR.random_blocked(32768, 128, 2.0, 0.3,
   seed=7)`` (the blocked canonical, blocked-32k-b128) through
   ``auto_executor`` -> ``BsrStagedExecutor`` -> ``run()`` -> ``assemble()``,
   with the launch counts set to 0 just before ``auto_executor`` and read
   just after ``assemble()`` (K3 exactly once, as its pipe kernel, no other
   kernel), bit-exact against scipy; then one-shot ``spgemm`` on the same
   operands (one more pipe K3 launch), bit-exact again;
9. K3 (grouped_block_matmul) equal to its plain PyTorch version through both
   of its kernels (the pipe kernel where it takes the tile side) on the real
   blocked-32k-b128 plan (``run()``'s real pairs, and the padded plan with
   its tail of scratch-block pairs), at tile sides 32, 64, 100 and 128, with
   one output block of 230 pairs, with all-ones tiles, on a plan with no
   padded tail, on 4,000 output blocks of 1-3 pairs at b = 64, on a plan
   with no pairs and on one whose pairs skip output blocks (the first and
   the last among them);
10. the blocked path's times: ``run()``, ``run()`` + ``assemble()``, the
    host clock's split of ``assemble()``, a ``torch.profiler`` breakdown of
    ``run()``, and at the route's shape, in turns, K3, its simple kernel, K3
    on the padded plan, its plain version and the ``backend="xla"``
    composition of library calls (all but the plain version from CUDA-graph
    replays), and ``zero_`` of K3's f32 output alone;
    then both K3 kernels on a plan of long pair groups (8 output blocks of
    128 pairs each at b = 128);
11. rows past K1's window: C = A·A for ``BCSR.rmat(16, 8.0, seed=7)``
    (batched, ``sort_pad`` 1,703,936) through ``auto_executor`` -> ``run()``
    -> ``assemble()``, bit-exact against scipy, every sort through
    ``torch.sort`` (``sort_rows.routes``), P4 once per dispatch group, with
    its times and P3/P4 over one of its dispatch groups as in phase 7;
12. the unrolled route at full size: C = A·A for rmat-s18-e8,
    ``BCSR.rmat(18, 8.0, seed=7)`` (a dealt plan: 256 chunks of
    4,980,736 slots in 10 dispatch groups), through ``auto_executor`` ->
    ``run()`` -> ``assemble()``, bit-exact against scipy, P3 once per
    dispatch group; its times, profile and peak memory; P3 and P4 over one
    of its dispatch groups as in phase 7, and split by width band (w < 32,
    32 <= w < 512, w >= 512), each band one group launch over its classes;
13. the unrolled contiguous plan: C = A·A for ``BCSR.random(32768, 32768,
    16.0, seed=7)`` the same way (P3 once per dispatch group, and over its
    group as in phase 7), then through one-shot ``spgemm``;
14. the host engine: ``spgemm`` on validity-class, ``BCSR.random(50000,
    50000, 0.5, seed=7)``, served by ``host_spgemm``, bit-exact;
15. P1 and P2 (``bitonic_network_rows``) and the sort drivers: the network
    ``torch.equal`` to its plain version at P1's three shapes and at L = 2,
    128, 256, 4096 and 32768 with min_kk = 2, 4, 32, L and 2L, on random rows
    and on rows of alternating sorted runs (where it must also equal
    ``torch.sort`` from min_kk <= 2w); P2's ``skip-w16`` equal to
    ``torch.sort`` on its run input; then each driver's ``main`` once
    (``benchmarks/pallas_sort``, ``ab_wruns``, ``sort_rate_table``,
    ``pallas_gather``), rows into ``build/``, every compared row bit-exact,
    with the launch counts set to 0 just before each and read just after; P1
    and P2 times beside ``torch.sort``, K1, their plain versions and their
    bound; P3/P4 at the ``pallas_gather`` driver's prototype shape as in
    phase 7; P1 at L = 8192 also through K1's shared-memory kernel, its
    route before K1's wide kernel;
16. ESC, giant rows and ``tuned_executor``: (a) the bench config through
    ``SpGEMMExecutor`` (one chunk, two-key int64 sort), equal to phase 5's
    product, no hand kernel and no ``sort_rows`` call, its times, profile and
    ``torch.sort``'s share of the busy time, the running maximum it scans
    with against ``torch.cummax`` at its length, then ``auto_executor`` with
    ``AUTO_ELL_MAX_SLOTS`` = 0 returning a ``SpGEMMExecutor``; (b)
    rmat-s18-e8 through one-shot ``spgemm(chunk_flops=DEFAULT_CHUNK_FLOPS)``
    (26 chunks), equal to phase 12's product, then ``SpGEMMExecutor``'s
    ``run()`` and peak memory beside phase 12's ELL ones; (c) the giant-row
    route on rmat-s16 with ``GIANT_ROW_FLOPS`` = 2^17 (17 rows windowed on
    the host, the rest through the ELL plan ``_auto_ell`` picks, with its
    launches), equal to phase 11's product; (d) ``tuned_executor`` on the
    bench config, its ``tune_report`` and a bit-exact winner, then again
    with ``times=10``, to show whether the winner holds;
17. the masked, union and fused-OR family and the one-sort step, each
    product bit-exact against scipy and its expected nnz, with the launch
    counts set to 0 just before it and read just after: on the bench config
    ``masked_spgemm(A, A, A)`` (the batched ``masked=True`` plan, K1's
    wide kernel twice a group, P4 once), again through ESC
    (``chunk_flops``, no hand kernel), ``spgemm_or(A, A, A)`` with and
    without ``mask=A``, ``spm_or(A, C)``, and ``run_padded()`` ->
    ``assemble_padded()`` equal to phase 5's product (K1's register kernel
    once a group); ``masked_spgemm(A, A, A)`` on rmat-s16 (batched,
    ``torch.sort``, P4) and random 32k (unrolled, ``torch.sort``, P3); the
    three ops on validity-class through the host routes (no launch).  Then
    K1 (its wide kernel) against K1's shared-memory kernel, its plain
    version and ``torch.sort``, in turns, on the three bench join streams
    (``[512, 7232]``, ``[1024, 4352]``, ``[512, 7552]``), the
    ``run_masked`` / ``run_or`` / ``run_padded`` medians beside phase 7's
    ``run()`` with their assembly and peak memory, and the staged side
    operands' running maximum along rows;
18. the counting family, each product held against scipy's int64 product
    (indptr, indices, and the counts equal to its data) and its expected nnz,
    with the launch counts, K1's variant counts and the sort routes set to 0
    just before it and read just after: on the bench config
    ``spgemm_counts(A, A)`` (the plain batched plan, K1's register kernel
    and P4 once a group; the counts sum to the product's flops), again with
    ``engine="esc"`` (no hand kernel), ``masked_spgemm_counts(A, A, A)``
    (the masked plan, K1's wide kernel and P4 once a group) and
    again with ``chunk_flops`` (ESC); ``triangle_count_device`` on the bench
    config and rmat-s16 made symmetric with an empty diagonal (5,340 and
    3,895,840 triangles, against scipy's ``G.multiply(G @ G).sum() // 6``),
    on the ELL plan (one tagged sort a group: K1's wide kernel on
    the bench graph, ``torch.sort`` on rmat-s16's unrolled plan) and through
    ESC; ``spgemm_counts`` on random 32k (the unrolled plan's chunk-local
    four-output form, P3) and on validity-class (the host engine, no
    launch).  Then K1 against K1's shared-memory kernel (where K1 takes
    another), its plain version and ``torch.sort`` on the rows the bench
    counting paths sort (``[1024, 3968]``, ``[512, 6912]``,
    ``[2048, 8096]``), and the ``run_counts`` / ``run_masked_counts`` /
    ``run_counts_sum`` medians beside phase 7's ``run()`` with their
    assembly, peak memory, idle share and share of the busy time in sort
    kernels;
19. the device API, the one-sort pipeline and the graph ops, with the launch
    counts, K1's variant counts and the sort routes set to 0 just before
    each op and read just after: (a) ``DeviceBCSR`` and ``ops/device_api.py``
    on the bench config (``flops_bound_device`` 16,735,925; the products,
    unions, masked products and counts equal to phases 5, 17 and 18's;
    ``counts_sum_device`` on phase 18's symmetric bench graph 6 x 5,340),
    no hand kernel; (b) ``spgemm_onesort_device`` (through ``to_host()``
    and ``compact()``) and ``spgemm_or_onesort_device`` with and without
    ``mask=A``, equal to phases 5 and 17's, with the stream length; (c)
    ``k_hop(A, 2)`` on the host route (phase 5's launches), the resident
    compacted and the resident one-sort routes, each equal to phase 5's
    product, and ``k_hop(A, 3, resident=True)`` raising ``OverflowError``
    on both resident routes; (d) ``transitive_closure`` of
    ``BCSR.random(65536, 65536, 1.0, seed=7)`` on the three routes, equal
    to scipy's (1,866,786 nnz, 8 rounds), with each route's wall, rounds,
    one-sort compactions, peak memory and launches (K1 on the host route
    its wide kernel only), then the host route's K1 rows (rounds 2-4,
    captured in one more host-route closure) timed as in phase 17; (e)
    ``triangle_structure``, ``triangle_count``, ``clustering_coefficients``
    (``np.array_equal`` to scipy's formula) and ``k_truss(G, 3)`` (scipy's
    peeling) on phase 18's symmetric bench graph, K1 there never its
    shared-memory kernel; (f) ``bfs_levels`` and
    ``reachable`` from three sources on the bench config against scipy's
    ``shortest_path``; (g) the CLI as subprocesses: ``gen`` writes (d)'s
    input and the bench config, then ``graph closure`` (its written file
    equal to (d)'s) and ``graph khop --resident`` (the bench product's nnz)
    run at once on the card;
20. the distributed layer over NCCL, one rank (``parallel/launch.py``):
    the bench config through ``dist_spgemm`` at every B layout
    (replicated, sharded, ring) and engine (ESC, ELL), and the wide-column
    product (``WIDE_COL``, 8192 x 2^24, d = 16) through the ELL engine;
    then the counting family: ``dist_spgemm_counts(A, A)`` at both engines
    and ``dist_masked_spgemm_counts(A, A, A)`` (indices and counts equal to
    phase 18's by digest), ``dist_triangle_count`` at both engines on phase
    18's symmetric bench graph (5,340), ``dist_transitive_closure`` of
    phase 19's closure input (equal to its 1,866,786-nnz closure, with its
    rounds and compactions) and ``dist_k_hop`` of it at k = 2 and 3 (equal
    to the single-card resident ``k_hop``, itself held to scipy; k = 3 is
    the product the JAX package's bound truncates);
21. the distributed layer over gloo, ranks sharing the one card: the same
    calls and the JAX dryrun's 19 paths (A = 128 x 128) in 4 ranks;
    ``dist_masked_spgemm(A, A, A)``, ``dist_spgemm_or(A, A, A)`` with and
    without ``mask=A``, ``dist_spm_or(A, C)``, ``dist_spgemm_from_local``
    (each rank reads its rows of the bench config written as ``.mtx``) and
    the wide-column product in 2 ranks.  Every rank's result must equal the
    single-card one (phases 5, 17, 18 and 19's, by digest; scipy's for the
    wide-column one), every step it assembles must hold its tensors (the
    counts payload too) on the card, every ELL call must launch P3 or P4
    and the dryrun K1 too, on every rank.  Each rank's ``sort_rows`` routes
    and K1 launches by variant are held against the plan the parent makes
    alike (``ell_sorts``, ``count_sorts``): on the bench's ELL products two
    ``torch.sort`` routes a stack (rows past K1's window), on its ELL
    counting calls one (the key sort; the payload sorts are ``torch.sort``
    calls outside ``sort_rows``), on the wide-column product two launches
    of K1's wide kernel, on the ESC, ring and one-sort forms none; K1
    launches equal its routes.  Each rank prints per call its host-clock
    wall, K1 launches by variant, P3/P4 launches, collective counters and
    peak device memory, K1's, P3's and P4's counts set to 0 just before the
    call and read just after.  A rank's failure or a launch past its time
    limit fails the phase;
22. the native host tier, the CLI's ``bench`` and K1's shared-memory
    kernel: (a) each native helper (``native/``, built in phase 2) equal,
    array for array, to its numpy branch at full size, both timed in turns
    on the host clock: the parse of phase 21's bench ``.mtx`` (1,047,402
    entries) and ``read_pattern`` of it, ``coo2csr`` on its entries, the
    ELL table fill and ``_build_class_entries`` and ``row_flops`` on the
    bench config and rmat-s16, the host engine's three products on
    validity-class, and the bench config's set-up (``auto_executor``) on
    the native tier and on the numpy branches; (b) ``cli.main(["bench",
    ...])`` in this process on the bench ``.mtx`` (``--no-transpose``: the
    bench config itself): ``--times 5 --json`` (16,703,465 nnz, 16
    register-K1 and 8 P4 launches a run, counted from 0 just before the
    call), ``--engine esc`` (no K1), ``--tune``, ``--sweep`` over two
    chunk sizes and ``--devices 2`` (two gloo ranks on the one card), then
    ``--scaling-report --devices 2 --json`` at esc x replicated and ell x
    sharded in one group of two gloo ranks, each ``bit_exact``; every CSV
    and JSON line printed; (c) K1's shared-memory kernel at ``[65536,
    128]`` against its plain version, timed beside it and ``torch.sort``;
23. a ``{"kernels": [...]}`` line (the graph ops' K1, P3 and P4 launches
    under ``launches_by_path["graph"]``, the distributed ones per rank under
    ``launches_by_path["distributed (per rank)"]``; K1's wide and
    shared-memory kernels as entries of their own, the wide one launched on
    the op family's ``run_or``, with every captured stream it sorts), then,
    last, the ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
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
# blocked-32k-b128: BCSR.random_blocked(n, block, blocks_per_row, density, seed)
BLOCKED = (32768, 128, 2.0, 0.3, 7)
BLOCKED_PAIRS, BLOCKED_PAIRS_PAD, BLOCKED_OUT = 1114, 1152, 1106
BLOCKED_NNZ = 18_120_588
LONG_GROUPS = (8, 128)  # output blocks x pairs each: K3's long-group plan
# BCSR.rmat(scale, edge_factor, seed): batched, rows past K1's window
RMAT16, RMAT16_NNZ = (16, 8.0, 7), 67_129_035
# rmat-s18-e8 (the JAX package's skew canonical): the unrolled dealt plan
RMAT18, RMAT18_NNZ = (18, 8.0, 7), 495_803_109
# phase 16's giant route: rmat-s16's rows past this many flops (the JAX tests
# lower GIANT_ROW_FLOPS the same way), and how many there are
GIANT_BUDGET, GIANT_ROWS = 1 << 17, 17
# BCSR.random(n, n, d, seed) below 2^16 rows: the unrolled contiguous plan
RAND32K, RAND32K_NNZ = (32768, 16.0, 7), 8_360_900
# validity-class, BCSR.random(n, n, d, seed): the host engine
VALIDITY, VALIDITY_NNZ = (50000, 0.5, 7), 12_596
# phase 17's op family (scipy's counts): F .* (A·A) with F = A on the bench
# config, rmat-s16 and random 32k, and A ∪ A·A on the bench config
BENCH_MASKED_NNZ, BENCH_OR_NNZ = 4_570, 17_746_297
RMAT16_MASKED_NNZ, RAND32K_MASKED_NNZ = 357_336, 4_535
# the wide K1 rows the op family sorts on the bench config: the masked join
# (sort_pad 6912 + mask pad 320), A ∪ A·A (3968 + D pad 160, bucketed) and
# the masked A ∪ A·A (6912 + 320 + 320)
OP_SHAPES = {"masked": (512, 7232), "or": (1024, 4352), "or-masked": (512, 7552)}
# phase 18's counting family (scipy's int64 product): the bench product's
# flops (its counts' sum), and the symmetric graphs with an empty diagonal
# made from the bench config and rmat-s16: (nnz, flops, triangles)
BENCH_COUNTS_FLOPS = 16_735_925
TRIANGLES = {"bench": (2_094_556, 69_041_936, 5_340),
             "rmat-s16": (955_194, 401_737_438, 3_895_840)}
# the K1 rows the counting family sorts on the bench config: the plain plan's
# stream (phase 7's shape), the masked plan's stage 1 (before the mask
# joins) and the symmetric bench graph's tagged sort (sort_pad 7936 + mask
# pad 160)
COUNT_SHAPES = {"counts": (1024, 3968), "masked counts": (512, 6912),
                "triangles": (2048, 8096)}
# the row lengths K1 sorts on the closure's host route (rounds 2-4; rounds 5-8
# sort past K1's window, through torch.sort)
CLOSURE_K1_ROWS = (4608, 4864, 17408)
# phase 19's closure input, BCSR.random(n, n, d, seed), its closure's nnz,
# the doubling rounds and the largest round's flops (scipy); BFS sources
CLOSURE, CLOSURE_NNZ = (65536, 1.0, 7), 1_866_786
CLOSURE_ROUNDS, CLOSURE_MAX_FLOPS = 8, 35_338_354
BFS_SOURCES = [0, 1, 12345]
GRAPH_ROUTES = {"host": {}, "resident": {"resident": True, "one_sort": False},
                "one-sort": {"resident": True}}
GATHER_WIDTHS = (1, 2, 3, 16, 40, 10240)
NETWORK_LENGTHS = (2, 128, 256, 4096, 32768)  # P1/P2 around K1's variant bounds
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12  # H100 SXM peak outside the tensor cores (FP32 rate)
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
INT32_MAX = (1 << 31) - 1
INT32_MIN = -(1 << 31)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


_START = time.perf_counter()


def phase(title: str) -> None:
    """Print a phase's header with the seconds since the script started."""
    print(f"== {title} (at {time.perf_counter() - _START:.1f} s)", flush=True)


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


def graph_timer(torch, fn, reps: int):
    """A timer of ``fn``'s device time: ``reps`` calls captured once in a
    CUDA graph; each call of the timer replays the graph and returns the
    mean ms per call, without the host's launch cost."""
    fn()  # warm-up: builds, caches and the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return lambda: event_ms(torch, graph.replay, 1) / reps


def sort_bound_ms(numel: int, length: int, sorts: int = 1) -> tuple[float, str]:
    """Least time for ``sorts`` row sorts of ``numel`` int32 keys in rows of
    ``length``: one read and one write over the memory rate, against
    ceil(log2 L) compares per key and sort over the peak rate."""
    bytes_ms = 2 * 4 * numel / HBM_BYTES_PER_S * 1e3
    ops_ms = (sorts * numel * max(1, (length - 1).bit_length())
              / INT32_OPS_PER_S * 1e3)
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def profile_run(torch, run, reps: int = 3, label: str = "run()") -> dict | None:
    """Device time of ``run()`` by kernel name (torch.profiler), and the
    device's idle share on the profiler's own device timeline: the time
    between the first recorded kernel's start and the last one's end that no
    kernel or copy covers.  Taking both from the recorded events keeps the
    share right when the profiler misses an event.  Returns ``{"busy_ms",
    "idle", "per_name_ms"}``, or ``None`` when no device time was
    recorded."""
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
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.key)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    if not spans:
        print(f"profile of {label}: the profiler recorded no device time "
              "(busy share not measured)")
        return None
    window = max(s[1] for s in spans) - spans[0][0]
    busy, reach = 0.0, spans[0][0]
    per_name: dict[str, list[float]] = {}
    for t0, t1, name in spans:
        busy += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
        per_name.setdefault(name, []).append(t1 - t0)
    print(f"profile of {label} (torch.profiler, {reps} runs, {len(spans)} device "
          f"events recorded): CUDA-event wall {wall:.4f} ms per run; device "
          f"timeline {window / 1e3:.4f} ms from the first kernel's start to the "
          f"last one's end, busy {busy / 1e3:.4f} ms, idle share "
          f"{1 - busy / window:.3f}")
    rows = sorted(((sum(v), len(v), k) for k, v in per_name.items()), reverse=True)
    for total, count, name in rows[:10]:
        print(f"  {total / 1e3:8.4f} ms  {total / busy:6.1%}  x{count} recorded, "
              f"{total / count / 1e3:.4f} ms each  {name[:80]}")
    return {"busy_ms": busy / 1e3 / reps, "idle": 1 - busy / window,
            "per_name_ms": {k: sum(v) / 1e3 / reps for k, v in per_name.items()}}


def ptxas_frames(report: str) -> dict[str, str]:
    """``{function: "N bytes stack frame, N bytes spill stores, ..."}`` from
    an ``nvcc -Xptxas -v`` report."""
    frames, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "bytes stack frame" in line and name is not None:
            frames[name] = line.strip()
    return frames


def k3_bound_ms(n_a: int, n_b: int, n_out: int, npairs: int, b: int
                ) -> tuple[float, str]:
    """Least time for K3: each bf16 input tile and int32 plan entry read
    once and each f32 output tile written once, over the memory rate,
    against 2 b³ operations per pair over the bf16 tensor-core peak."""
    nbytes = (n_a + n_b) * b * b * 2 + n_out * b * b * 4 + 4 * npairs * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * npairs * b**3 / BF16_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def k3_case(torch, rng, b: int, group_sizes: list[int], *, n_tiles: int = 9,
            ones: bool = False, tail: bool = True) -> list:
    """K3's arguments on the card: random 0/1 bf16 tiles (all ones with
    ``ones``) and a sorted, bucket-padded pair plan with ``group_sizes[s]``
    pairs into output block s (its real pairs only, without ``tail``)."""
    from binary_spgemm_tpu_torch.ops.bsr import _pad_pair_plan

    shape = (n_tiles, b, b)
    if ones:
        ta, tb = np.ones(shape, np.uint8), np.ones(shape, np.uint8)
    else:
        ta = (rng.random(shape) < 0.3).astype(np.uint8)
        tb = (rng.random(shape) < 0.3).astype(np.uint8)
    seg = np.repeat(np.arange(len(group_sizes)), group_sizes)
    ka = rng.integers(0, n_tiles, len(seg))
    kb = rng.integers(0, n_tiles, len(seg))
    plan = _pad_pair_plan(ka, kb, seg, len(group_sizes))
    if not tail:
        plan = [x[: len(seg)] for x in plan]
    tiles = [torch.from_numpy(t).cuda().to(torch.bfloat16) for t in (ta, tb)]
    return [torch.from_numpy(x).cuda() for x in plan] + tiles


def gather_case(torch, rng, w: int, g: int, pad: int, nc: int = 37,
                rows_pad: int = 8, n_cols: int = 1000) -> tuple:
    """P3/P4 arguments on the card: a class table with sentinel tails, row
    ids with staged padding rows and one past the sentinel row, positions
    with out-of-range and negative ones."""
    table = rng.integers(0, n_cols, (nc, w)).astype(np.int32)
    lens = rng.integers(1, w + 1, nc)
    table[np.arange(w)[None, :] >= lens[:, None]] = n_cols
    rows = rng.integers(0, rows_pad, (g, pad)).astype(np.int32)
    pos = rng.integers(0, nc, (g, pad)).astype(np.int32)
    if g and pad >= 4:
        rows[:, -2:] = rows_pad
        rows[0, 0] = rows_pad + 5
        pos[:, -2:] = 0
        pos[-1, :4] = [nc, nc + 9, -1, -nc - 3]
    return tuple(torch.from_numpy(x).cuda() for x in (table, pos, rows)) + (
        rows_pad, n_cols)


def gather_bound_ms(classes, g: int, out_bytes: int) -> tuple[float, str]:
    """Least time for the gathers of one dispatch group: each class's
    positions and row ids read once, its table read once (L2-resident),
    each output slot written once (``out_bytes`` per slot), over the memory
    rate; against 3 operations per slot over the peak rate."""
    nbytes = sum(8 * g * pad + 4 * t.numel() + out_bytes * g * pad * w
                 for t, _, _, w, pad, _ in classes)
    slots = sum(g * pad * w for _, _, _, w, pad, _ in classes)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * slots / INT32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def group_gathers(ell, ex, row0: int) -> list:
    """The gathered classes of one dispatch group of ``ex``: ``(table,
    rows, pos, w, pad, col0)`` each, ``col0`` its first column in the
    group's stream, as ``run()`` hands them to P3/P4."""
    tables = ell._unpack_tables(ex.tables_flat, ex.table_shapes)
    spans = tuple(p * w if s is None else p
                  for s, w, p in zip(ex.table_shapes, ex.widths, ex.pads))
    er, ep = ell._unpack_entries(ex.er_all, ex.ep_all, row0, ex.group_size,
                                 ex.pads, spans)
    out, off = [], 0
    for t, r, p, w, pad in zip(tables, er, ep, ex.widths, ex.pads):
        if t is not None:
            out.append((t, r, p, w, pad, off))
        off += pad * w
    return out


def group_launches(gather, ex) -> int:
    """P3/P4 launches a ``run()`` of ``ex`` makes: one per dispatch group
    that has a gathered class (more past ``GROUP_CAP`` classes)."""
    gathered = sum(s is not None for s in ex.table_shapes)
    return ex.n_groups * -(-gathered // gather.GROUP_CAP)


def time_gathers(torch, gather, classes, g: int, rp: int, nc_: int, width: int,
                 label: str, reps: int, full: bool = True) -> dict:
    """P3 and P4 over ``classes`` (``group_gathers``' tuples), the gathered
    classes of one dispatch group of ``g`` rows, written into a ``[g,
    width]`` stream as ``run()`` writes them: one group launch each, checked
    to launch once per ``GROUP_CAP`` classes and held ``torch.equal`` to the
    plain version in every class's span.  Then, in turns, the group launches,
    the plain versions and ``torch.index_select(table, 0, pos)`` per class
    (the library call for the gather alone).  Kernels and library call are
    timed from CUDA-graph replays of ``reps`` group calls (a group's launches
    are shorter than their host time); the plain versions, whose indexing
    may synchronise, over ``reps`` calls back to back.  Without ``full``,
    only the group launches."""
    shift = int(nc_).bit_length()
    check((rp + 1) << shift <= 1 << 31, f"{label}: keys do not pack")
    dev = classes[0][0].device
    key = torch.empty((g, width), dtype=torch.int32, device=dev)
    row = torch.empty_like(key)
    col = torch.empty_like(key)
    group = [(t, p, r, off) for t, r, p, _, _, off in classes]
    slots = sum(g * pad * w for _, _, _, w, pad, _ in classes)

    def p3():
        gather.class_gather_group(group, rp, nc_, (row, col))

    def p4():
        gather.class_gather_keys_group(group, rp, nc_, shift, key)

    n3, n4 = gather.class_gather.launches, gather.class_gather_keys.launches
    p3()
    p4()
    per_group = -(-len(classes) // gather.GROUP_CAP)
    check(gather.class_gather.launches - n3 == per_group
          and gather.class_gather_keys.launches - n4 == per_group,
          f"{label}: the group launches were not {per_group} each")
    torch.cuda.synchronize()
    for t, r, p, w, pad, off in classes:
        want_r, want_c = gather.class_gather_plain(t, p, r, rp, nc_)
        want_k = gather.class_gather_keys_plain(t, p, r, rp, nc_, shift)
        span = slice(off, off + pad * w)
        check(torch.equal(row[:, span], want_r) and torch.equal(col[:, span], want_c),
              f"{label}: P3 differs from its plain version, class w={w}")
        check(torch.equal(key[:, span], want_k),
              f"{label}: P4 differs from its plain version, class w={w}")
    fns = {"p3": p3, "p4": p4}
    flat = [(t, p.reshape(-1).contiguous()) for t, _, p, _, _, _ in classes]
    if full:
        fns.update({
            "p3_plain": lambda: gather.class_gather_group_plain(group, rp, nc_, (row, col)),
            "p4_plain": lambda: gather.class_gather_keys_group_plain(
                group, rp, nc_, shift, key),
            "lib": lambda: [torch.index_select(t, 0, fp) for t, fp in flat]})
    timers = {}
    for name, fn in fns.items():
        fn()
        if name.endswith("plain"):
            timers[name] = lambda fn=fn: event_ms(torch, fn, reps)
        else:
            timers[name] = graph_timer(torch, fn, reps)
    order = list(fns)
    times: dict[str, list[float]] = {}
    for name in order + order[::-1]:  # in turns: forward, then back
        times.setdefault(name, []).append(timers[name]())
    del timers
    t = {name: min(v) for name, v in times.items()}
    b3, b3_by = gather_bound_ms(classes, g, 8)
    b4, b4_by = gather_bound_ms(classes, g, 4)
    shape = {"group": g, "classes": len(classes),
             "widths": [w for _, _, _, w, _, _ in classes], "slots": slots,
             "launches": per_group}
    if full:
        print(f"{label} ({g} rows, {len(classes)} gathered classes, {slots} slots, "
              f"{per_group} launch each): P3 {t['p3']:.4f} ms, plain "
              f"{t['p3_plain']:.4f} ms, bound {b3:.4f} ms ({b3_by}); P4 {t['p4']:.4f} "
              f"ms, plain {t['p4_plain']:.4f} ms, "
              f"bound {b4:.4f} ms ({b4_by}); torch.index_select per class "
              f"{t['lib']:.4f} ms")
    else:
        print(f"{label} ({len(classes)} classes, widths {shape['widths'][:3]}..., "
              f"{slots} slots): P3 {t['p3']:.4f} ms, bound {b3:.4f} ms; P4 "
              f"{t['p4']:.4f} ms, bound {b4:.4f} ms")
    return {"t": t, "bound3": (b3, b3_by), "bound4": (b4, b4_by), "shape": shape}


def time_path_gathers(torch, gather, ell, ex, label: str, reps: int) -> dict:
    """``time_gathers`` over ``ex``'s first dispatch group."""
    return time_gathers(torch, gather, group_gathers(ell, ex, 0), ex.group_size,
                        ex.rows_pad, ex.n_cols, ex.sort_pad, label, reps)


def gather_row(res: dict, kernel: str, launches: int, label: str) -> dict:
    """One shape's numbers for P3 (``kernel`` "p3") or P4 ("p4") in the
    kernels line."""
    bound = res["bound3" if kernel == "p3" else "bound4"]
    t = res["t"]
    return {"shape": dict(res["shape"], path=label), "ms": t[kernel],
            "plain_ms": t[kernel + "_plain"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": t["lib"], "launches": launches}


def group_case(torch, rng, widths, g: int, pad: int) -> tuple[list, int]:
    """One dispatch group of classes of ``widths`` (``gather_case`` each) for
    the group entry points: inputs as column slices of wider staged arrays,
    each class's span from an odd first column of a stream whose row stride
    is not a multiple of 4.  Returns ``(classes, width)``, the classes as
    ``(table, pos, rows, col0)``."""
    parts = [gather_case(torch, rng, w, g, pad, nc=37 + k) for k, w in enumerate(widths)]
    wide_pos = torch.cat([torch.zeros((g, 3), dtype=torch.int32, device="cuda")]
                         + [x[1] for x in parts], dim=1)
    wide_rows = torch.cat([torch.full((g, 3), 8, dtype=torch.int32, device="cuda")]
                          + [x[2] for x in parts], dim=1)
    classes, off, col0 = [], 3, 5
    for x, w in zip(parts, widths):
        classes.append((x[0], wide_pos[:, off : off + pad], wide_rows[:, off : off + pad],
                        col0))
        off += pad
        col0 += pad * w
    return classes, col0 + 7 if (col0 + 7) % 4 else col0 + 6


def network_cases(torch, bitonic, ab_wruns, dev, rng) -> tuple[int, int]:
    """P1/P2 against their plain version at each of NETWORK_LENGTHS, at
    min_kk = 2, 4, 32, L and 2L, on random rows (duplicates, int32
    extremes) and on rows of alternating w-aligned sorted runs, which must
    come out sorted from min_kk <= 2w.  Returns the largest difference seen
    and the number of cases."""
    err, n_cases = 0, 0
    for L in NETWORK_LENGTHS:
        k = max(8, (1 << 16) // L)
        w = min(16, L // 2)
        x = rng.integers(INT32_MIN, INT32_MAX, (k, L), dtype=np.int64, endpoint=True
                         ).astype(np.int32)
        x[0, : L // 2] = x[0, 0]  # duplicates
        x[1, :1] = INT32_MAX
        x[-1, :1] = INT32_MIN
        x = torch.from_numpy(x).to(dev)
        runs = ab_wruns.alternating_runs(x, w)
        want_sorted = torch.sort(x, dim=1).values
        for min_kk in (2, 4, 32, L, 2 * L):
            for label, inp in (("random", x), ("runs", runs)):
                got = bitonic.bitonic_network_rows(inp, min_kk)
                want = bitonic.bitonic_network_rows_plain(inp, min_kk)
                err = max(err, int((got.long() - want.long()).abs().max()))
                check(torch.equal(got, want),
                      f"the network differs from its plain version: L={L}, "
                      f"min_kk={min_kk}, {label} rows")
                if label == "runs" and min_kk <= 2 * w:
                    check(torch.equal(got, want_sorted),
                          f"the network does not sort w={w} runs: L={L}, min_kk={min_kk}")
                n_cases += 1
    return err, n_cases


def drive_ell_path(torch, label: str, a, expected_nnz: int, *, reset_counts,
                   read_counts, routes, auto_executor, spgemm_oracle,
                   runs: int, e2e_runs: int, profile_reps: int):
    """C = A·A through ``auto_executor`` -> ``run()`` -> ``assemble()``,
    the launch counts and sort routes set to 0 just before and read just
    after; bit-exact against scipy; then ``run()`` and ``run()`` +
    ``assemble()`` timed with CUDA events and ``run()`` profiled.  Returns
    the executor, the launches, the routes, the times and the product."""
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex = auto_executor(a, a)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    out = ex.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    c = ex.assemble(out)
    launches, rts = read_counts(), dict(routes)
    del out
    form = "batched" if ex.batched else (
        "unrolled, dealt" if ex.row_sets is not None else "unrolled, contiguous")
    gathered = sum(s is not None for s in ex.table_shapes)
    print(f"{label}: input nnz {a.nnz}; plan + stage {plan_s:.2f} s: {form}, "
          f"k={ex.n_chunks} sort_pad={ex.sort_pad} groups={ex.n_groups}x"
          f"{ex.group_size} rows_pad={ex.rows_pad} classes={len(ex.widths)} "
          f"({gathered} gathered) out_pad={ex.out_pad}")
    print(f"peak device memory through run(): {peak / 2**20:.1f} MiB")
    print(f"launches in auto_executor -> run() -> assemble(): {launches}; "
          f"sort_rows routes {rts}")
    t0 = time.perf_counter()
    ref = spgemm_oracle(a, a)
    oracle_s = time.perf_counter() - t0
    check(c.equals(ref), f"{label}: C = A·A differs from scipy")
    check(c.nnz == expected_nnz, f"{label}: output nnz {c.nnz} != {expected_nnz}")
    print(f"C = A·A bit-exact against scipy (oracle {oracle_s:.2f} s): output "
          f"nnz {c.nnz}")
    del ref
    ex.run()
    torch.cuda.synchronize()
    run_ms = [event_ms(torch, ex.run, 1) for _ in range(runs)]
    e2e_ms = [event_ms(torch, lambda: ex.assemble(ex.run()), 1)
              for _ in range(e2e_runs)]
    print(f"run(): median {statistics.median(run_ms):.4f} ms, fastest "
          f"{min(run_ms):.4f} ms, slowest {max(run_ms):.4f} ms ({runs} runs)")
    print(f"run() + assemble(): median {statistics.median(e2e_ms):.2f} ms, "
          f"fastest {min(e2e_ms):.2f} ms, slowest {max(e2e_ms):.2f} ms "
          f"({e2e_runs} runs)")
    profile_run(torch, ex.run, reps=profile_reps)
    return ex, launches, rts, {"run_ms": statistics.median(run_ms),
                               "e2e_ms": statistics.median(e2e_ms),
                               "peak_mib": peak / 2**20}, c


def esc_phase(torch, card: str, *, api, reset_counts, read_counts, routes,
              bench, rmat18, rmat16, giant_budget: int, expect: dict) -> dict:
    """ESC, the giant-row route and ``tuned_executor`` (phase 16).  ``bench``,
    ``rmat18`` and ``rmat16`` are ``(A, C = A·A, extra)`` from the earlier
    phases, their products already bit-exact against scipy, so each product
    here is held equal to theirs.  ``api`` holds the entry points and
    modules.  Launch counts and sort routes are set to 0 just before each
    route and read just after it.  Returns the numbers for the summary."""
    sp, ell, host = api["spgemm_mod"], api["ell"], api["host"]
    SpGEMMExecutor, spgemm = api["SpGEMMExecutor"], api["spgemm"]
    out: dict = {}

    def no_kernel(label: str) -> dict:
        launches, rts = read_counts(), dict(routes)
        print(f"{label}: launches {launches}; sort_rows routes {rts}")
        check(not any(launches.values()) and not any(rts.values()),
              f"{label}: a hand kernel or sort_rows ran on the ESC path")
        return launches

    def sort_share(prof) -> float | None:
        """Share of the device's busy time in kernels named *sort*
        (torch.sort's radix passes)."""
        if prof is None:
            return None
        return sum(v for k, v in prof["per_name_ms"].items()
                   if "sort" in k.lower()) / prof["busy_ms"]

    # (a) the bench config through the staged ESC executor
    a, c, k_auto = bench
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex = SpGEMMExecutor(a, a)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    res = ex.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ce = ex.assemble(res)
    no_kernel("bench config, SpGEMMExecutor -> run() -> assemble()")
    del res
    packed = sp.packable(ex._rows_pad, ex.n_cols)
    print(f"bench config through SpGEMMExecutor(a, a): plan + stage {plan_s:.2f} s: "
          f"{len(ex.chunks)} chunk(s), rows_pad {ex._rows_pad}, flops_pad "
          f"{ex.flops_pad}, {'packed int32' if packed else 'two-key int64'} sort key; "
          f"peak device memory through run() {peak / 2**20:.1f} MiB")
    check((len(ex.chunks), ex.flops_pad, packed) == expect["bench_plan"],
          f"bench ESC plan {(len(ex.chunks), ex.flops_pad, packed)}, "
          f"expected {expect['bench_plan']}")
    check(ce.equals(c), "bench ESC product differs from phase 5's")
    print(f"C = A·A through ESC equal to phase 5's product (bit-exact against "
          f"scipy): output nnz {ce.nnz}")
    del ce
    ex.run()
    torch.cuda.synchronize()
    run_ms = [event_ms(torch, ex.run, 1) for _ in range(7)]
    e2e_ms = [event_ms(torch, lambda: ex.assemble(ex.run()), 1) for _ in range(3)]
    print(f"ESC run(): median {statistics.median(run_ms):.4f} ms, fastest "
          f"{min(run_ms):.4f}, slowest {max(run_ms):.4f} (7 runs); run() + assemble(): "
          f"median {statistics.median(e2e_ms):.2f} ms, fastest {min(e2e_ms):.2f}, "
          f"slowest {max(e2e_ms):.2f} (3 runs); {card}")
    prof = profile_run(torch, ex.run, reps=3)
    share = sort_share(prof)
    print(f"share of the busy time in kernels named *sort* (torch.sort): "
          f"{'not measured' if share is None else f'{share:.3f}'}")
    # the running maximum expand_pairs scans with, against torch.cummax (one
    # serial row scan) on a stream of the chunk's length
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(0, 1 << 30, (ex.flops_pad,), dtype=torch.int32, device="cuda",
                      generator=gen)
    want = torch.cummax(x, 0).values
    check(torch.equal(sp._running_max(x), want), "_running_max differs from torch.cummax")
    scan = {"cummax_ms": min(event_ms(torch, lambda: torch.cummax(x, 0), 1) for _ in range(2)),
            "running_max_ms": min(event_ms(torch, lambda: sp._running_max(x), 10)
                                  for _ in range(2))}
    print(f"running maximum of {ex.flops_pad} int32 slots: torch.cummax "
          f"{scan['cummax_ms']:.4f} ms, _running_max (rows of {sp._SCAN_ROW}) "
          f"{scan['running_max_ms']:.4f} ms, equal; {card}")
    del x, want
    out["bench"] = {"run_ms": statistics.median(run_ms), "e2e_ms": statistics.median(e2e_ms),
                    "peak_mib": peak / 2**20, "sort_share": share,
                    "idle": None if prof is None else prof["idle"], **scan}
    # auto_executor falls to ESC past the resident ELL budget
    saved = ell.AUTO_ELL_MAX_SLOTS
    ell.AUTO_ELL_MAX_SLOTS = 0
    try:
        aex = api["auto_executor"](a, a)
    finally:
        ell.AUTO_ELL_MAX_SLOTS = saved
    check(isinstance(aex, sp.SpGEMMExecutor) and aex.chunks == ex.chunks
          and aex.flops_pad == ex.flops_pad,
          f"auto_executor past AUTO_ELL_MAX_SLOTS returned {type(aex).__name__}")
    check(aex.assemble(aex.run()).equals(c), "auto_executor's ESC product differs")
    print("auto_executor(a, a) with AUTO_ELL_MAX_SLOTS = 0: a SpGEMMExecutor of the "
          "same plan, bit-exact")
    del ex, aex

    # (b) rmat-s18-e8 through one-shot spgemm(chunk_flops=), then staged
    a18, c18, ell18 = rmat18
    rf = sp.row_flops(a18, a18)
    chunks, rows_pad, _, flops_pad = sp.uniform_chunk_plan(
        a18, rf, sp.DEFAULT_CHUNK_FLOPS, a18.n_cols)
    print(f"rmat-s18-e8 ESC plan: {len(chunks)} chunks, rows_pad {rows_pad}, flops_pad "
          f"{flops_pad}, {'packed' if sp.packable(rows_pad, a18.n_cols) else 'two-key'}")
    check(len(chunks) == expect["rmat18_chunks"],
          f"rmat-s18-e8: {len(chunks)} ESC chunks, expected {expect['rmat18_chunks']}")
    reset_counts()
    t0 = time.perf_counter()
    cs = spgemm(a18, a18, chunk_flops=sp.DEFAULT_CHUNK_FLOPS)
    one_shot_s = time.perf_counter() - t0
    no_kernel("rmat-s18-e8, spgemm(chunk_flops=DEFAULT_CHUNK_FLOPS)")
    check(cs.equals(c18), "rmat-s18-e8 ESC product differs from phase 12's")
    print(f"one-shot spgemm(a18, a18, chunk_flops={sp.DEFAULT_CHUNK_FLOPS}): equal to "
          f"phase 12's product, output nnz {cs.nnz}, {one_shot_s:.2f} s on the host clock")
    del cs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex = SpGEMMExecutor(a18, a18)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    idx, nnz = ex.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    real = int(nnz.sum()) - len(ex.chunks) * ex._rows_pad  # less the separators
    check(real == c18.nnz, f"rmat-s18-e8 staged ESC counts {real} entries")
    del idx, nnz
    run_ms = [event_ms(torch, ex.run, 1) for _ in range(3)]
    print(f"SpGEMMExecutor(a18, a18): plan + stage {plan_s:.2f} s; run() median "
          f"{statistics.median(run_ms):.2f} ms (fastest {min(run_ms):.2f}, slowest "
          f"{max(run_ms):.2f}, 3 runs), peak device memory {peak / 2**20:.1f} MiB; "
          f"phase 12's ELL run() median {ell18['run_ms']:.2f} ms, peak "
          f"{ell18['peak_mib']:.1f} MiB; {card}")
    prof = profile_run(torch, ex.run, reps=1)
    share = sort_share(prof)
    out["rmat18"] = {"run_ms": statistics.median(run_ms), "one_shot_s": one_shot_s,
                     "peak_mib": peak / 2**20, "ell_run_ms": ell18["run_ms"],
                     "ell_peak_mib": ell18["peak_mib"], "chunks": len(ex.chunks),
                     "sort_share": share, "idle": None if prof is None else prof["idle"]}
    print(f"share of the busy time in kernels named *sort*: "
          f"{'not measured' if share is None else f'{share:.3f}'}")
    del ex
    torch.cuda.empty_cache()

    # (c) the giant-row route on rmat-s16, its rows past giant_budget windowed
    a16, c16, _ = rmat16
    rf = sp.row_flops(a16, a16)
    n_giant = int((rf > giant_budget).sum())
    check(n_giant == expect["giant_rows"],
          f"rmat-s16: {n_giant} rows past {giant_budget} flops")
    picked, served = [], []
    real_auto_ell, real_host = ell._auto_ell, host.host_spgemm

    def spy_auto_ell(a_, b_, **kw):
        picked.append(real_auto_ell(a_, b_, **kw))
        return picked[-1]

    saved = sp.GIANT_ROW_FLOPS
    sp.GIANT_ROW_FLOPS = giant_budget
    ell._auto_ell = spy_auto_ell
    host.host_spgemm = lambda a_, b_: served.append(1) or real_host(a_, b_)
    try:
        reset_counts()
        t0 = time.perf_counter()
        cg = spgemm(a16, a16)
        giant_s = time.perf_counter() - t0
        launches, rts = read_counts(), dict(routes)
    finally:
        sp.GIANT_ROW_FLOPS = saved
        ell._auto_ell = real_auto_ell
        host.host_spgemm = real_host
    check(len(picked) == 1, f"the rest product built {len(picked)} ELL executors")
    rex = picked[0]
    form = "batched" if rex.batched else (
        "unrolled, dealt" if rex.row_sets is not None else "unrolled, contiguous")
    print(f"rmat-s16 with GIANT_ROW_FLOPS = {giant_budget}: {n_giant} giant rows "
          f"({int(rf[rf > giant_budget].sum())} flops) in {len(served)} windows through "
          f"host_spgemm; the rest through the {form} ELL plan (k={rex.n_chunks} "
          f"sort_pad={rex.sort_pad} groups={rex.n_groups}x{rex.group_size})")
    print(f"launches in spgemm: {launches}; sort_rows routes {rts}")
    packed_rest = launches["class_gather_keys"] > 0  # keys: two sort_rows a group
    check(launches["class_gather"] + launches["class_gather_keys"] > 0
          and (not packed_rest or rts["k1"] + rts["torch_sort"] == 2 * rex.n_groups)
          and launches["bitonic_sort_rows"] == rts["k1"]
          and not (launches["grouped_block_matmul"] or launches["fused_sort_compress"]
                   or launches["bitonic_network_rows"]),
          "the rest product did not run its ELL plan's kernels")
    check(cg.equals(c16), "the giant route's product differs from phase 11's")
    print(f"giant route equal to phase 11's product: output nnz {cg.nnz}, "
          f"{giant_s:.2f} s on the host clock; {card}")
    out["giant"] = {"rows": n_giant, "windows": len(served), "s": giant_s,
                    "rest_plan": form, "launches": launches}
    del cg, rex, picked

    # (d) tuned_executor on the bench config
    reset_counts()
    t0 = time.perf_counter()
    tex = api["tuned_executor"](a, a)
    tune_s = time.perf_counter() - t0
    launches = read_counts()
    report = [(round(t * 1e3, 4), k) for t, k in tex.tune_report]
    win_k = tex.tune_report[0][1]
    print(f"tuned_executor(a, a) in {tune_s:.2f} s: tune_report (ms, k) {report}; {card}")
    print(f"winner k={win_k} ({'batched' if tex.batched else 'unrolled'}) beside "
          f"auto_executor's k={k_auto}; launches while tuning {launches}")
    check(any(k == 0 for _, k in report) and len(report) >= 2
          and win_k == (tex.n_chunks if tex.batched else 0),
          f"tune_report {report}")
    check(launches["bitonic_sort_rows"] > 0 and launches["class_gather_keys"] > 0
          and launches["class_gather"] > 0,
          "the candidates did not run K1, P4 (batched) and P3 (unrolled)")
    check(tex.assemble(tex.run()).equals(c), "tuned_executor's winner differs")
    print("the winner's C = A·A equals phase 5's product (bit-exact)")
    out["tuned"] = {"report_ms_k": report, "winner_k": win_k, "auto_k": k_auto,
                    "s": tune_s}
    del tex
    # the same candidates timed ten times each: does the winner hold?
    t0 = time.perf_counter()
    tex = api["tuned_executor"](a, a, times=10)
    tune_s = time.perf_counter() - t0
    report10 = [(round(t * 1e3, 4), k) for t, k in tex.tune_report]
    print(f"tuned_executor(a, a, times=10) in {tune_s:.2f} s: tune_report (ms, k) "
          f"{report10}; winner k={report10[0][1]}; {card}")
    check(sorted(k for _, k in report10) == sorted(k for _, k in report),
          f"times=10 measured other candidates: {report10}")
    check(tex.assemble(tex.run()).equals(c), "tuned_executor's times=10 winner differs")
    out["tuned"]["times10"] = {"report_ms_k": report10, "winner_k": report10[0][1],
                               "s": tune_s}
    return out


def capture_sort_inputs(sp, fn, max_len: int | None = None) -> dict:
    """Run ``fn()`` with the ``sort_rows`` the compress steps call spied on:
    the first input of each distinct shape (rows up to ``max_len`` slots
    where given), cloned (a join's unsorted stream; the demoted one that
    follows has the same shape)."""
    seen: dict = {}
    real = sp.sort_rows_1key

    def spy(x):
        if tuple(x.shape) not in seen and (max_len is None or x.shape[1] <= max_len):
            seen[tuple(x.shape)] = x.clone()
        return real(x)

    sp.sort_rows_1key = spy
    try:
        fn()
    finally:
        sp.sort_rows_1key = real
    return seen


def time_k1_stream(torch, bitonic, x, label: str, card: str) -> dict:
    """K1 on a captured stream ``x``: bit-equal to its plain version (and PR
    1's shared-memory kernel, where K1 takes another kernel at this length,
    bit-equal too), then K1, that kernel, the plain version and
    ``torch.sort`` timed in turns (forward, then back), each beside the
    bound.  Returns the row for the kernels line."""
    k, L = x.shape
    variant = bitonic.k1_variant(L)
    got, want = bitonic.bitonic_sort_rows(x), bitonic.bitonic_sort_rows_plain(x)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want), f"K1 differs at the {label} {[k, L]}")
    fns = [("k1", lambda: bitonic.bitonic_sort_rows(x))]
    if variant != "smem":
        check(torch.equal(bitonic._sort_rows_variant(x, "smem"), want),
              f"K1's shared-memory kernel differs at the {label} {[k, L]}")
        fns.append(("smem", lambda: bitonic._sort_rows_variant(x, "smem")))
    fns += [("plain", lambda: bitonic.bitonic_sort_rows_plain(x)),
            ("lib", lambda: torch.sort(x, dim=1))]
    st: dict[str, list[float]] = {}
    for name, fn in fns + fns[::-1]:
        st.setdefault(name, []).append(event_ms(torch, fn, 20))
    b_ms, b_by = sort_bound_ms(x.numel(), L)
    row = {"path": label, "shape": [k, L], "variant": variant, "ms": min(st["k1"]),
           "previous_ms": min(st["smem"]) if "smem" in st else None,
           "plain_ms": min(st["plain"]), "library_ms": min(st["lib"]),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    if variant == "wide":
        row["block"] = list(bitonic.wide_block(L))
    prev = ("" if row["previous_ms"] is None
            else f", K1's smem kernel {row['previous_ms']:.4f} ms")
    print(f"K1 ({variant}) on the {label} {[k, L]}: bit-equal to its plain version; "
          f"{row['ms']:.4f} ms{prev}, plain {row['plain_ms']:.4f} ms, torch.sort "
          f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{row['ms'] / b_ms:.1f}x the bound; {card}")
    return row


def op_family_phase(torch, card: str, *, api, reset_counts, read_counts, routes,
                    k1_by_variant, bench, bench_run_ms: float) -> dict:
    """The masked, union and fused-OR family and the one-sort step (phase
    17).  ``bench`` is ``(A, C = A·A)`` from phase 5, C already bit-exact
    against scipy.  Every product is held against scipy (the oracles of
    ``utils/oracle.py``, ``A + C`` in scipy) and its expected nnz; the
    launch counts and sort routes are set to 0 just before each product and
    read just after.  Then K1 against its plain version and ``torch.sort``
    on the join streams the bench products sort, and the ``run_*`` times.
    Returns the numbers for the summary and the kernels line."""
    sp, ell, bitonic, host = api["spgemm_mod"], api["ell"], api["bitonic"], api["host"]
    BCSR, masked_oracle = api["BCSR"], api["masked_spgemm_oracle"]
    a, c = bench
    sa = a.to_scipy()
    out: dict = {"products": {}}

    def csr(m):
        m = m.tocsr()
        m.eliminate_zeros()
        m.sort_indices()
        return BCSR(m.indptr, m.indices, m.shape)

    def peak_above(base: int) -> float:
        """MiB allocated at the peak beyond what was held before (earlier
        phases' tensors)."""
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    def drive(label, fn, ref, nnz, keep=None):
        reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, rts, k1v = read_counts(), dict(routes), dict(k1_by_variant)
        peak = peak_above(base)
        print(f"{label}: {secs:.2f} s on the host clock (plan, stage, run, assemble); "
              f"launches {launches}; K1 by variant {k1v}; sort_rows routes {rts}; "
              f"peak device memory {peak:.1f} MiB above the {base / 2**20:.1f} MiB "
              f"held before")
        check(got.equals(ref), f"{label} differs from scipy")
        check(got.nnz == nnz, f"{label}: output nnz {got.nnz} != {nnz}")
        print(f"  bit-exact against scipy: output nnz {got.nnz}")
        out["products"][label] = {"s": secs, "launches": launches, "k1_by_variant": k1v,
                                  "routes": rts, "peak_mib": peak, "nnz": got.nnz}
        if keep:  # a result phase 19 holds its own against
            out.setdefault("results", {})[keep] = got
        return launches, rts, k1v

    # (a) the bench config, every product on the ELL routes
    masked_ref = masked_oracle(a, a, a)
    or_ref = csr(sa + c.to_scipy())
    launches, rts, k1v = drive("bench masked_spgemm(A, A, A)",
                               lambda: api["masked_spgemm"](a, a, a), masked_ref,
                               BENCH_MASKED_NNZ, keep="masked")
    exm = ell.cached_executor(a, a, masked=True)
    print(f"  masked plan: k={exm.n_chunks} groups={exm.n_groups}x{exm.group_size} "
          f"rows_pad={exm.rows_pad} sort_pad={exm.sort_pad} mask pad "
          f"{exm.staged_nnz_pad(a)}")
    check(exm.batched and k1v == {"reg": 0, "wide": 2 * exm.n_groups, "smem": 0}
          and launches["class_gather_keys"] == exm.n_groups
          and launches["class_gather"] == 0,
          "the bench masked product did not sort with K1's wide kernel and P4")
    launches, rts, k1v = drive("bench spgemm_or(A, A, A)",
                               lambda: api["spgemm_or"](a, a, a), or_ref, BENCH_OR_NNZ,
                               keep="or")
    exo = ell.cached_executor(a, a)
    check(k1v == {"reg": 0, "wide": 2 * exo.n_groups, "smem": 0}
          and launches["class_gather_keys"] == exo.n_groups,
          "bench A ∪ A·A did not sort with K1's wide kernel and P4")
    launches, rts, k1v = drive("bench spgemm_or(A, A, A, mask=A)",
                               lambda: api["spgemm_or"](a, a, a, mask=a),
                               a.sum_duplicates(), a.sum_duplicates().nnz, keep="or-masked")
    check(k1v == {"reg": 0, "wide": 2 * exm.n_groups, "smem": 0}
          and launches["class_gather_keys"] == exm.n_groups,
          "the bench masked A ∪ A·A did not sort with K1's wide kernel and P4")
    drive("bench spm_or(A, C)", lambda: api["spm_or"](a, c), or_ref, BENCH_OR_NNZ)
    ex = api["auto_executor"](a, a)
    reset_counts()
    padded = ex.run_padded()
    torch.cuda.synchronize()
    cp = ex.assemble_padded(padded)
    launches, rts, k1v = read_counts(), dict(routes), dict(k1_by_variant)
    print(f"bench run_padded() -> assemble_padded(): launches {launches}; K1 by "
          f"variant {k1v}; sort_rows routes {rts}")
    check(cp.equals(c), "assemble_padded(run_padded()) differs from phase 5's product")
    check(k1v == {"reg": ex.n_groups, "wide": 0, "smem": 0}
          and launches["class_gather_keys"] == ex.n_groups,
          "run_padded did not sort once a group with K1's register kernel")
    print(f"  equal to phase 5's product (bit-exact against scipy): output nnz {cp.nnz}")
    out["products"]["bench run_padded"] = {"launches": launches, "k1_by_variant": k1v,
                                           "routes": rts, "nnz": cp.nnz}
    del padded, cp
    launches, rts, _ = drive(
        "bench masked_spgemm(A, A, A, chunk_flops=DEFAULT_CHUNK_FLOPS) (ESC)",
        lambda: api["masked_spgemm"](a, a, a, chunk_flops=sp.DEFAULT_CHUNK_FLOPS),
        masked_ref, BENCH_MASKED_NNZ)
    check(not any(launches.values()) and not any(rts.values()),
          "a hand kernel or sort_rows ran on the masked ESC path")

    # (b) the masked product on the other plans
    for label, make, nnz, expect in (
            ("rmat-s16", lambda: BCSR.rmat(*RMAT16[:2], seed=RMAT16[2]), RMAT16_MASKED_NNZ,
             "batched"),
            ("random 32k", lambda: BCSR.random(RAND32K[0], RAND32K[0], RAND32K[1],
                                               seed=RAND32K[2]), RAND32K_MASKED_NNZ,
             "unrolled")):
        m = make()
        launches, rts, k1v = drive(f"{label} masked_spgemm(A, A, A)",
                                   lambda: api["masked_spgemm"](m, m, m),
                                   masked_oracle(m, m, m), nnz)
        e = ell.cached_executor(m, m, masked=True)
        print(f"  masked plan: {'batched' if e.batched else 'unrolled'} k={e.n_chunks} "
              f"groups={e.n_groups}x{e.group_size} rows_pad={e.rows_pad} "
              f"sort_pad={e.sort_pad} mask pad {e.staged_nnz_pad(m)}")
        gathers = launches["class_gather_keys" if e.batched else "class_gather"]
        check(e.batched == (expect == "batched") and gathers == e.n_groups
              and rts == {"k1": 0, "torch_sort": 2 * e.n_groups},
              f"{label}: the masked product did not take the expected plan and kernels")
        del m, e
        ell._EXEC_CACHE.clear()

    # (c) validity-class through the host routes (A ∩ A·A is empty there, so
    # the mask is A·A itself)
    av = BCSR.random(VALIDITY[0], VALIDITY[0], VALIDITY[1], seed=VALIDITY[2])
    sv = av.to_scipy()
    cv = csr(sv @ sv)
    for label, fn, ref in (
            ("validity-class masked_spgemm(A·A, A, A)",
             lambda: api["masked_spgemm"](cv, av, av), masked_oracle(cv, av, av)),
            ("validity-class spgemm_or", lambda: api["spgemm_or"](av, av, av),
             csr(sv + sv @ sv)),
            ("validity-class spm_or", lambda: api["spm_or"](av, av), av.sum_duplicates())):
        launches, rts, _ = drive(label, fn, ref, ref.nnz)
        check(not any(launches.values()) and not any(rts.values()),
              f"{label}: a kernel ran on the host route")

    # (d) K1 on the join streams, against its plain version and torch.sort
    staged_a = exm.stage_mask(a)
    staged_o = exo.stage_mask(a)
    streams = {}
    for label, fn in (("masked", lambda: exm.run_masked(staged_a)),
                      ("or", lambda: exo.run_or(staged_o)),
                      ("or-masked", lambda: exm.run_or(staged_a, mask=staged_a))):
        got = capture_sort_inputs(sp, fn)
        check(OP_SHAPES[label] in got, f"{label}: no sort at {OP_SHAPES[label]}, "
              f"sorted {sorted(got)}")
        streams[label] = got[OP_SHAPES[label]]
    k1_rows = [time_k1_stream(torch, bitonic, x, f"bench {label} join stream", card)
               for label, x in streams.items()]
    out["k1"], out["k1_err"] = k1_rows, max(r["max_abs_err"] for r in k1_rows)
    del streams

    # (e) the run_* times beside phase 7's run(), assemble() and peak memory
    times = {}
    for label, e, run in (("run_masked", exm, lambda: exm.run_masked(staged_a)),
                          ("run_or", exo, lambda: exo.run_or(staged_o)),
                          ("run_or(mask=)", exm, lambda: exm.run_or(staged_a, mask=staged_a)),
                          ("run_padded", ex, ex.run_padded)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = run()
        torch.cuda.synchronize()
        peak = peak_above(base)
        asm = e.assemble_padded if label == "run_padded" else e.assemble
        del res
        run_ms = [event_ms(torch, run, 1) for _ in range(15)]
        e2e_ms = [event_ms(torch, lambda: asm(run()), 1) for _ in range(3)]
        prof = profile_run(torch, run, reps=1, label=label)
        times[label] = {"run_ms": statistics.median(run_ms), "e2e_ms": statistics.median(e2e_ms),
                        "peak_mib": peak, "busy_ms": None if prof is None else prof["busy_ms"],
                        "idle": None if prof is None else prof["idle"]}
        print(f"{label}: median {times[label]['run_ms']:.4f} ms (fastest {min(run_ms):.4f}, "
              f"slowest {max(run_ms):.4f}, 15 runs); with {asm.__name__}() median "
              f"{times[label]['e2e_ms']:.2f} ms (3 runs); peak device memory {peak:.1f} "
              f"MiB above the staged operands; phase 7's run() {bench_run_ms:.4f} ms; {card}")
    out["times"] = times

    # the staged side operands' running maximum (torch.cummax along rows)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scans = {}
    for shape in ((512, 320), (1024, 160)):
        x = torch.randint(0, 1 << 30, shape, dtype=torch.int32, device="cuda", generator=gen)
        check(torch.equal(sp._running_max(x), torch.cummax(x, 1).values),
              "_running_max differs from torch.cummax along rows")
        scans[str(list(shape))] = min(event_ms(torch, lambda: sp._running_max(x), 50)
                                      for _ in range(2))
        print(f"running maximum along the rows of {list(shape)} (torch.cummax(dim=1)): "
              f"{scans[str(list(shape))]:.4f} ms; {card}")
    out["cummax_ms"] = scans
    ell._EXEC_CACHE.clear()
    return out


def counting_phase(torch, card: str, *, api, reset_counts, read_counts, routes,
                   k1_by_variant, bench, bench_run_ms: float) -> dict:
    """The counting family (phase 18).  ``bench`` is phase 5's A.  Every
    product is held against scipy's int64 product (indptr, indices, and the
    counts equal to its data after ``sort_indices()``) and its expected nnz,
    every triangle count against scipy's ``G.multiply(G @ G).sum() // 6``;
    the launch counts, K1's variant counts and the sort routes are set to 0
    just before each product and read just after.  Then K1 against its
    plain version and ``torch.sort`` on the rows these paths sort, and the
    ``run_counts`` / ``run_masked_counts`` / ``run_counts_sum`` times.
    Returns the numbers for the summary and the kernels line."""
    sp, ell, bitonic, counts = api["spgemm_mod"], api["ell"], api["bitonic"], api["counts"]
    BCSR, spgemm_counts = api["BCSR"], api["spgemm_counts"]
    masked_spgemm_counts = api["masked_spgemm_counts"]
    a = bench
    out: dict = {"products": {}}

    def int_product(x, y, f=None):
        c = x.to_scipy().astype(np.int64) @ y.to_scipy().astype(np.int64)
        if f is not None:
            c = c.multiply(f.to_scipy().astype(np.int64)).tocsr()
            c.eliminate_zeros()
        c.sort_indices()
        return c

    def symmetric_hollow(m):
        s = m.to_scipy()
        s = ((s + s.T) > 0).astype(np.int64).tolil()
        s.setdiag(0)
        s = s.tocsr()
        s.eliminate_zeros()
        return BCSR.from_scipy(s)

    def peak_above(base: int) -> float:
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    def drive(label, fn, verify, keep=None):
        reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, rts, k1v = read_counts(), dict(routes), dict(k1_by_variant)
        peak = peak_above(base)
        print(f"{label}: {secs:.2f} s on the host clock (plan, stage, run, assemble); "
              f"launches {launches}; K1 by variant {k1v}; sort_rows routes {rts}; "
              f"peak device memory {peak:.1f} MiB above the {base / 2**20:.1f} MiB "
              f"held before")
        verify(got)
        out["products"][label] = {"s": secs, "launches": launches, "k1_by_variant": k1v,
                                  "routes": rts, "peak_mib": peak}
        if keep:  # a result phase 19 holds its own against
            out.setdefault("results", {})[keep] = got
        return launches, rts, k1v

    def counts_equal(label, ref, nnz, flops=None):
        def verify(got):
            c, cnt = got
            check(c.nnz == nnz, f"{label}: output nnz {c.nnz} != {nnz}")
            check(np.array_equal(c.indptr, ref.indptr)
                  and np.array_equal(c.indices, ref.indices),
                  f"{label}: structure differs from scipy's")
            check(cnt.dtype == np.int64 and np.array_equal(cnt, ref.data),
                  f"{label}: counts differ from scipy's int64 product")
            if flops is not None:
                check(int(cnt.sum()) == flops,
                      f"{label}: counts sum {int(cnt.sum())} != spgemm_flops {flops}")
            print(f"  bit-exact against scipy's int64 product: output nnz {c.nnz}, "
                  f"counts sum {int(cnt.sum())}, largest {int(cnt.max())}")
        return verify

    def triangles_equal(label, want):
        def verify(got):
            check(got == want, f"{label}: {got} triangles, scipy {want}")
            print(f"  {got} triangles, equal to scipy's G.multiply(G @ G).sum() // 6")
        return verify

    def plan_launches(label, e, launches, rts, k1v, row_len):
        """The launches a counting product's ELL plan must show: one sort of
        rows of ``row_len`` a group through sort_rows (K1's kernel for that
        length, or torch.sort past K1's window) and one P4 (batched, packed)
        or P3 group launch."""
        g = e.n_groups
        gather = "class_gather_keys" if e.batched else "class_gather"
        if row_len > bitonic.MAX_L:
            want_k1, want_rts = {"reg": 0, "wide": 0, "smem": 0}, {"k1": 0, "torch_sort": g}
        else:
            want_k1 = {"reg": 0, "wide": 0, "smem": 0}
            want_k1[bitonic.k1_variant(row_len)] = g
            want_rts = {"k1": g, "torch_sort": 0}
        print(f"  plan: {'batched' if e.batched else 'unrolled'} k={e.n_chunks} "
              f"groups={e.n_groups}x{e.group_size} rows_pad={e.rows_pad} "
              f"sort_pad={e.sort_pad}; first sort's rows {row_len}")
        check(k1v == want_k1 and rts == want_rts and launches[gather] == g
              and launches["class_gather_keys"] + launches["class_gather"] == g
              and launches["bitonic_sort_rows"] == want_rts["k1"],
              f"{label}: launches {launches}, K1 {k1v}, routes {rts}; expected K1 "
              f"{want_k1}, routes {want_rts}, {gather} {g}")

    def no_launches(label, launches, rts):
        check(not any(launches.values()) and not any(rts.values()),
              f"{label}: a hand kernel or sort_rows ran ({launches}, {rts})")

    # (a) the bench config
    flops = sp.spgemm_flops(a, a)
    check(flops == BENCH_COUNTS_FLOPS, f"bench flops {flops} != {BENCH_COUNTS_FLOPS}")
    ref = int_product(a, a)
    label = "bench spgemm_counts(A, A)"
    res = drive(label, lambda: spgemm_counts(a, a),
                counts_equal(label, ref, EXPECTED_NNZ, flops), keep="counts")
    ex = ell.cached_executor(a, a)
    check(ex.batched, "bench spgemm_counts did not take the batched plan")
    plan_launches(label, ex, *res, ex.sort_pad)
    label = "bench spgemm_counts(A, A, engine='esc')"
    res = drive(label, lambda: spgemm_counts(a, a, engine="esc"),
                counts_equal(label, ref, EXPECTED_NNZ, flops))
    no_launches(label, *res[:2])
    del ref
    refm = int_product(a, a, a)
    label = "bench masked_spgemm_counts(A, A, A)"
    res = drive(label, lambda: masked_spgemm_counts(a, a, a),
                counts_equal(label, refm, BENCH_MASKED_NNZ), keep="masked counts")
    exm = ell.cached_executor(a, a, masked=True)
    plan_launches(label, exm, *res, exm.sort_pad)
    label = "bench masked_spgemm_counts(A, A, A, chunk_flops=DEFAULT_CHUNK_FLOPS)"
    res = drive(label, lambda: masked_spgemm_counts(a, a, a,
                                                    chunk_flops=sp.DEFAULT_CHUNK_FLOPS),
                counts_equal(label, refm, BENCH_MASKED_NNZ))
    no_launches(label, *res[:2])

    # (b) triangles of two symmetric graphs with an empty diagonal
    graphs = {}
    for name, make in (("bench", lambda: a),
                       ("rmat-s16", lambda: BCSR.rmat(*RMAT16[:2], seed=RMAT16[2]))):
        g = symmetric_hollow(make())
        nnz, g_flops, tri = TRIANGLES[name]
        s = g.to_scipy()
        support = s.multiply(s @ s).tocsr()  # each edge's common neighbours
        want = int(support.sum()) // 6
        if name == "bench":  # phase 19 runs the graph ops on it
            out["bench_symmetric"] = (g, support)
        check(g.nnz == nnz and sp.spgemm_flops(g, g) == g_flops and want == tri,
              f"symmetric {name}: nnz {g.nnz}, flops {sp.spgemm_flops(g, g)}, scipy "
              f"{want} triangles; expected {TRIANGLES[name]}")
        label = f"{name} symmetric triangle_count_device(G)"
        res = drive(label, lambda: counts.triangle_count_device(g),
                    triangles_equal(label, tri))
        e = ell.cached_executor(g, g, masked=True)
        plan_launches(label, e, *res, e.sort_pad + e.staged_nnz_pad(g))
        label = f"{name} symmetric triangle_count_device(G, chunk_flops=DEFAULT_CHUNK_FLOPS)"
        res = drive(label, lambda: counts.triangle_count_device(
            g, chunk_flops=sp.DEFAULT_CHUNK_FLOPS), triangles_equal(label, tri))
        no_launches(label, *res[:2])
        graphs[name] = (g, e)
    # the bench plans stay referenced here; the rmat-s16 one is released
    del graphs["rmat-s16"], g, e, s, support
    ell._EXEC_CACHE.clear()

    # (c) random 32k: the unrolled plan's chunk-local four-output form
    m = BCSR.random(RAND32K[0], RAND32K[0], RAND32K[1], seed=RAND32K[2])
    label = "random 32k spgemm_counts(A, A)"
    res = drive(label, lambda: spgemm_counts(m, m),
                counts_equal(label, int_product(m, m), RAND32K_NNZ, sp.spgemm_flops(m, m)))
    e = ell.cached_executor(m, m)
    check(not e.batched, "random 32k spgemm_counts did not take the unrolled plan")
    plan_launches(label, e, *res, e.sort_pad)
    del m, e

    # (d) validity-class through the host engine
    av = BCSR.random(VALIDITY[0], VALIDITY[0], VALIDITY[1], seed=VALIDITY[2])
    label = "validity-class spgemm_counts(A, A)"
    res = drive(label, lambda: spgemm_counts(av, av),
                counts_equal(label, int_product(av, av), VALIDITY_NNZ,
                             sp.spgemm_flops(av, av)))
    no_launches(label, *res[:2])

    # (e) K1 on the rows the bench counting paths sort, against its plain
    # version and torch.sort
    staged_a = exm.stage_mask(a)
    g_bench, e_bench = graphs["bench"]
    staged_g = e_bench.stage_mask(g_bench)
    streams = {}
    for label, fn in (("counts", ex.run_counts),
                      ("masked counts", lambda: exm.run_masked_counts(staged_a)),
                      ("triangles", lambda: e_bench.run_counts_sum(staged_g))):
        got = capture_sort_inputs(sp, fn)
        check(COUNT_SHAPES[label] in got, f"{label}: no sort at {COUNT_SHAPES[label]}, "
              f"sorted {sorted(got)}")
        streams[label] = got[COUNT_SHAPES[label]]
    k1_rows = [time_k1_stream(torch, bitonic, x, f"bench {label} stream", card)
               for label, x in streams.items()]
    out["k1"], out["k1_err"] = k1_rows, max(r["max_abs_err"] for r in k1_rows)
    del streams

    # (f) the run_* times beside phase 7's run(), with assembly, peak memory
    # and the share of the busy time in sort kernels
    def sum_host(e, run):
        return lambda: int(run().cpu().numpy()[: e.n_chunks].astype(np.int64).sum())

    times = {}
    for label, e, run, asm in (
            ("run_counts", ex, ex.run_counts, lambda: ex.assemble_counts(ex.run_counts())),
            ("run_masked_counts", exm, lambda: exm.run_masked_counts(staged_a),
             lambda: exm.assemble_counts(exm.run_masked_counts(staged_a))),
            ("run_counts_sum", exm, lambda: exm.run_counts_sum(staged_a),
             sum_host(exm, lambda: exm.run_counts_sum(staged_a)))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = run()
        torch.cuda.synchronize()
        peak = peak_above(base)
        del res
        run_ms = [event_ms(torch, run, 1) for _ in range(15)]
        e2e_ms = [event_ms(torch, asm, 1) for _ in range(3)]
        prof = profile_run(torch, run, reps=1, label=label)
        sort_share = None
        if prof is not None:
            sort_ms = sum(v for k, v in prof["per_name_ms"].items() if "sort" in k.lower())
            sort_share = sort_ms / prof["busy_ms"]
        times[label] = {"run_ms": statistics.median(run_ms),
                        "e2e_ms": statistics.median(e2e_ms), "peak_mib": peak,
                        "busy_ms": None if prof is None else prof["busy_ms"],
                        "idle": None if prof is None else prof["idle"],
                        "sort_share": sort_share}
        share = "not measured" if sort_share is None else f"{sort_share:.3f}"
        print(f"{label}: median {times[label]['run_ms']:.4f} ms (fastest {min(run_ms):.4f}, "
              f"slowest {max(run_ms):.4f}, 15 runs); with assembly median "
              f"{times[label]['e2e_ms']:.2f} ms (3 runs); peak device memory {peak:.1f} MiB "
              f"above the staged operands; share of busy time in sort kernels {share}; "
              f"phase 7's run() {bench_run_ms:.4f} ms; {card}")
    out["times"] = times
    ell._EXEC_CACHE.clear()
    return out


def closure_oracle(s):
    """R <- R OR R·R to the fixpoint with scipy (``s`` an int64 CSR):
    ``(closure, rounds, largest round's flops)``, rounds counted as the
    resident loops count their products."""
    r = (s > 0).astype(np.int64).tocsr()
    rounds, most = 0, 0
    while True:
        lens = np.diff(r.indptr)
        most = max(most, int(lens[r.indices].sum()))
        rounds += 1
        nxt = ((r + r @ r) > 0).astype(np.int64).tocsr()
        if nxt.nnz == r.nnz:
            r.sort_indices()
            return r, rounds, most
        r = nxt


def graph_phase(torch, card: str, *, api, reset_counts, read_counts, routes,
                k1_by_variant, bench, main_launches, op_results, count_results,
                bench_symmetric) -> dict:
    """The device API, the one-sort pipeline and the graph ops (phase 19).
    ``bench`` is ``(A, C = A·A)`` from phase 5; ``op_results`` phase 17's
    ``spgemm_or`` / ``masked_spgemm`` products, ``count_results`` phase 18's
    bench counts, ``bench_symmetric`` phase 18's symmetric bench graph G and
    scipy's ``G.multiply(G @ G)``.  Every result is held against those or
    against scipy; the launch counts, K1's variant counts and the sort
    routes are set to 0 just before each op and read just after.  Returns
    the numbers for the summary and the kernels line."""
    from scipy.sparse.csgraph import shortest_path

    from binary_spgemm_tpu_torch.io.mmio import read_pattern
    from binary_spgemm_tpu_torch.ops import device_api as dapi
    from binary_spgemm_tpu_torch.ops import graph, onesort

    sp, ell, BCSR, bitonic = api["spgemm_mod"], api["ell"], api["BCSR"], api["bitonic"]
    DeviceBCSR = sp.DeviceBCSR
    a, c = bench
    g, support = bench_symmetric
    out: dict = {"products": {}, "k_hop_s": {}}

    def peak_above(base: int) -> float:
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    def drive(label, fn):
        reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, rts, k1v = read_counts(), dict(routes), dict(k1_by_variant)
        peak = peak_above(base)
        print(f"{label}: {secs:.3f} s on the host clock; launches {launches}; K1 by "
              f"variant {k1v}; sort_rows routes {rts}; peak device memory {peak:.1f} MiB "
              f"above the {base / 2**20:.1f} MiB held before")
        out["products"][label] = {"s": secs, "launches": launches, "k1_by_variant": k1v,
                                  "routes": rts, "peak_mib": peak}
        return got, launches, rts

    def no_launches(label, launches, rts):
        check(not any(launches.values()) and not any(rts.values()),
              f"{label}: a hand kernel or sort_rows ran ({launches}, {rts})")

    def same(label, got, want):
        check(got.equals(want), f"{label} differs from {want!r}")
        print(f"  equal: output nnz {got.nnz}")

    def wide_k1(label, launches):
        """K1's launches on a graph op whose joins sort rows past 4096 slots:
        the wide kernel, never the shared-memory one."""
        k1v = out["products"][label]["k1_by_variant"]
        check(k1v["wide"] > 0 and k1v["smem"] == 0
              and sum(k1v.values()) == launches["bitonic_sort_rows"],
              f"{label}: K1 by variant {k1v}, expected the wide kernel")

    # (a) the device API on the bench config: ESC in torch ops, no hand kernel
    da = DeviceBCSR.from_host(a, require_canonical=True)
    fb = dapi.flops_bound_device(da, da)
    check(int(fb) == BENCH_COUNTS_FLOPS, f"flops_bound_device {int(fb)} != {BENCH_COUNTS_FLOPS}")
    fp = sp.pad_bucket(int(fb))
    print(f"flops_bound_device(A, A) = {int(fb)}; flops_pad {fp}")
    for label, fn, want in (
            ("spgemm_device(A, A)", lambda: dapi.spgemm_device(da, da, flops_pad=fp), c),
            ("spgemm_or_device(A, A, A)", lambda: dapi.spgemm_or_device(da, da, da, flops_pad=fp),
             op_results["or"]),
            ("spgemm_or_device(A, A, A, mask=A)",
             lambda: dapi.spgemm_or_device(da, da, da, flops_pad=fp, mask=da),
             op_results["or-masked"]),
            ("masked_spgemm_device(A, A, A)",
             lambda: dapi.masked_spgemm_device(da, da, da, flops_pad=fp), op_results["masked"])):
        got, launches, rts = drive(label, lambda: fn().to_host())
        no_launches(label, launches, rts)
        same(label, got, want)
    for label, fn, (want, want_cnt) in (
            ("spgemm_counts_device(A, A)",
             lambda: dapi.spgemm_counts_device(da, da, flops_pad=fp), count_results["counts"]),
            ("masked_spgemm_counts_device(A, A, A)",
             lambda: dapi.masked_spgemm_counts_device(da, da, da, flops_pad=fp),
             count_results["masked counts"])):
        (dc, cnt), launches, rts = drive(label, fn)
        no_launches(label, launches, rts)
        got = dc.to_host()
        check(got.equals(want) and np.array_equal(cnt[: got.nnz].cpu().numpy(), want_cnt),
              f"{label} differs from phase 18's counts")
        print(f"  equal to phase 18's: output nnz {got.nnz}, counts sum {int(want_cnt.sum())}")
    dg = DeviceBCSR.from_host(g, require_canonical=True)
    fbg = int(dapi.flops_bound_device(dg, dg))
    check(fbg == TRIANGLES["bench"][1], f"symmetric bench flops {fbg}")
    label = "counts_sum_device(G, G, G) (bench symmetric)"
    total, launches, rts = drive(label, lambda: int(dapi.counts_sum_device(
        dg, dg, dg, flops_pad=sp.pad_bucket(fbg))))
    no_launches(label, launches, rts)
    check(total == 6 * TRIANGLES["bench"][2], f"{label} = {total}")
    print(f"  {total} = 6 x {TRIANGLES['bench'][2]} triangles")
    del dg

    # (b) one-sort on the bench config
    pa = onesort.PaddedDeviceBCSR.from_device(da)
    fbo, est = onesort.flops_bound_onesort(pa, pa)
    check(int(fbo) == BENCH_COUNTS_FLOPS and float(est) == float(BENCH_COUNTS_FLOPS),
          f"flops_bound_onesort {int(fbo)}, {float(est)}")
    label = "spgemm_onesort_device(A, A)"
    s1, launches, rts = drive(label, lambda: onesort.spgemm_onesort_device(pa, pa,
                                                                          flops_pad=fp))
    no_launches(label, launches, rts)
    print(f"  stream length {s1.stream_len} against nnz {int(s1.nnz)} "
          f"({s1.stream_len / int(s1.nnz):.4f}x)")
    same(f"{label}.to_host()", s1.to_host(), c)
    same(f"{label}.compact().to_host()", s1.compact().to_host(), c)
    out["onesort_stream"] = {"stream_len": s1.stream_len, "nnz": int(s1.nnz)}
    del s1
    for label, mask, want in (("spgemm_or_onesort_device(A, A, A)", None, op_results["or"]),
                              ("spgemm_or_onesort_device(A, A, A, mask=A)", pa,
                               op_results["or-masked"])):
        s2, launches, rts = drive(label, lambda: onesort.spgemm_or_onesort_device(
            pa, pa, pa, flops_pad=fp, mask=mask))
        no_launches(label, launches, rts)
        print(f"  stream length {s2.stream_len} against nnz {int(s2.nnz)}")
        same(label, s2.to_host(), want)
        del s2
    del da, pa

    # (c) k-hop on the bench config: A² on the three routes, A³ past the
    # resident budget
    for route, kw in GRAPH_ROUTES.items():
        label = f"k_hop(A, 2), {route} route"
        got, launches, rts = drive(label, lambda: graph.k_hop(a, 2, **kw))
        if route == "host":  # phase 5's plan: K1 (registers) and P4
            check(launches == main_launches,
                  f"{label}: launches {launches}, phase 5's {main_launches}")
        else:
            no_launches(label, launches, rts)
        same(label, got, c)
        out["k_hop_s"][route] = out["products"][label]["s"]
    for route in ("resident", "one-sort"):
        try:
            graph.k_hop(a, 3, **GRAPH_ROUTES[route])
        except OverflowError as err:
            print(f"k_hop(A, 3), {route} route: OverflowError: {err}")
        else:
            raise SmokeError(f"k_hop(A, 3), {route} route did not raise OverflowError")
    ell._EXEC_CACHE.clear()

    # (d) the transitive closure on the three routes
    m = BCSR.random(CLOSURE[0], CLOSURE[0], CLOSURE[1], seed=CLOSURE[2])
    t0 = time.perf_counter()
    ref, rounds, most = closure_oracle(m.to_scipy())
    want = BCSR(ref.indptr, ref.indices, ref.shape)
    check((want.nnz, rounds, most) == (CLOSURE_NNZ, CLOSURE_ROUNDS, CLOSURE_MAX_FLOPS),
          f"scipy's closure: nnz {want.nnz}, {rounds} rounds, largest {most} flops")
    print(f"closure of BCSR.random({CLOSURE[0]}, {CLOSURE[0]}, {CLOSURE[1]}, seed={CLOSURE[2]}) "
          f"({m.nnz} nnz) with scipy: {want.nnz} nnz in {rounds} rounds, the largest "
          f"{most} flops ({time.perf_counter() - t0:.2f} s)")
    steps = {"host": "spgemm_or", "resident": "spgemm_or_device",
             "one-sort": "spgemm_or_onesort_device"}
    closure = {}
    for route, kw in GRAPH_ROUTES.items():
        calls = {"rounds": 0, "regates": 0}
        step, regate = getattr(graph, steps[route]), graph._onesort_regate

        def counted_step(*args, **kwargs):
            calls["rounds"] += 1
            return step(*args, **kwargs)

        def counted_regate(r):
            res = regate(r)
            calls["regates"] += res is not r
            return res

        setattr(graph, steps[route], counted_step)
        graph._onesort_regate = counted_regate
        label = f"transitive_closure, {route} route"
        try:
            got, launches, rts = drive(label, lambda: graph.transitive_closure(m, **kw))
        finally:
            setattr(graph, steps[route], step)
            graph._onesort_regate = regate
        if route == "host":  # the late rounds run the ELL executor's run_or
            check(launches["bitonic_sort_rows"] > 0 and launches["class_gather_keys"] > 0,
                  f"{label}: K1 or P4 never ran ({launches})")
            wide_k1(label, launches)
        else:
            no_launches(label, launches, rts)
        same(label, got, want)
        rec = out["products"][label]
        rec.update(calls)
        closure[route] = {"s": rec["s"], **calls, "peak_mib": rec["peak_mib"],
                          "k1": launches["bitonic_sort_rows"], "k1_by_variant": rec["k1_by_variant"],
                          "p3": launches["class_gather"], "p4": launches["class_gather_keys"],
                          "routes": rts}
        print(f"  {route}: {rec['s']:.3f} s wall, {calls['rounds']} rounds, "
              f"{calls['regates']} one-sort compactions, peak {rec['peak_mib']:.1f} MiB, "
              f"K1 {launches['bitonic_sort_rows']} ({rec['k1_by_variant']}), P3 "
              f"{launches['class_gather']}, P4 {launches['class_gather_keys']}, "
              f"sort_rows routes {rts}; {card}")
    out["closure"] = closure
    out["closure_input"] = (m, want)  # phases 20-21 hold the distributed closure to it
    ell._EXEC_CACHE.clear()
    # the rows K1 sorts on the closure's host route (rounds 2-4), captured in
    # one more host-route closure, against K1's shared-memory kernel and
    # torch.sort
    streams = capture_sort_inputs(sp, lambda: graph.transitive_closure(m),
                                  max_len=bitonic.MAX_L)
    check(sorted(L for _, L in streams) == list(CLOSURE_K1_ROWS),
          f"the closure's host route sorted K1 rows {sorted(streams)}, expected lengths "
          f"{CLOSURE_K1_ROWS}")
    out["k1"] = [time_k1_stream(torch, bitonic, streams[shape],
                                "closure host-route round stream", card)
                 for shape in sorted(streams, key=lambda kl: kl[1])]
    del streams
    ell._EXEC_CACHE.clear()

    # (e) triangles, clustering and the 3-truss of the symmetric bench graph
    n = g.n_rows
    tri_structure = support.copy()
    tri_structure.eliminate_zeros()
    tri_structure.sort_indices()
    label = "triangle_structure(G)"
    got, launches, _ = drive(label, lambda: graph.triangle_structure(g))
    wide_k1(label, launches)
    same(label, got, BCSR(tri_structure.indptr, tri_structure.indices, (n, n)))
    label = "triangle_count(G)"
    got, launches, _ = drive(label, lambda: graph.triangle_count(g))
    wide_k1(label, launches)
    check(got == TRIANGLES["bench"][2], f"{label} = {got}")
    print(f"  {got} triangles")
    label = "clustering_coefficients(G)"
    got, launches, _ = drive(label, lambda: graph.clustering_coefficients(g))
    wide_k1(label, launches)
    tri2 = np.asarray(support.sum(axis=1)).ravel().astype(np.int64)
    deg = np.diff(g.indptr).astype(np.int64)
    pairs = deg * (deg - 1)
    cc = np.zeros(n, np.float64)
    nz = pairs > 0
    cc[nz] = tri2[nz] / pairs[nz]
    check(got.dtype == np.float64 and np.array_equal(got, cc),
          f"{label} differs from scipy's formula")
    print(f"  equal to scipy's formula (np.array_equal): mean {got.mean():.6g}, "
          f"{int((got > 0).sum())} nodes above 0")
    d, sup = g.to_scipy(), support.copy()
    while True:  # scipy's peeling: drop edges in no triangle of the subgraph
        sup.data = (sup.data >= 1).astype(np.int64)
        sup.eliminate_zeros()
        if sup.nnz == d.nnz:
            break
        d = sup.tocsr()
        sup = d.multiply(d @ d).tocsr()
    d = d.tocsr()
    d.sort_indices()
    label = "k_truss(G, 3)"
    got, launches, _ = drive(label, lambda: graph.k_truss(g, 3))
    wide_k1(label, launches)
    same(label, got, BCSR(d.indptr, d.indices, (n, n)))
    ell._EXEC_CACHE.clear()

    # (f) BFS from three sources on the bench config
    label = f"bfs_levels(A, {BFS_SOURCES})"
    lv, launches, rts = drive(label, lambda: graph.bfs_levels(a, BFS_SOURCES))
    dist = shortest_path(a.to_scipy(), directed=True, unweighted=True,
                         indices=BFS_SOURCES).min(axis=0)
    want_lv = np.where(np.isinf(dist), -1, dist).astype(np.int32)
    check(np.array_equal(lv, want_lv), f"{label} differs from scipy's shortest_path")
    check(np.array_equal(graph.reachable(a, BFS_SOURCES), np.flatnonzero(want_lv >= 0)),
          "reachable differs from scipy's shortest_path")
    print(f"  equal to scipy's shortest_path: {int((lv >= 0).sum())} reached, "
          f"{int(lv.max())} levels; the frontier products on the host engine: "
          f"launches {launches}")

    # (g) the CLI: gen, then graph closure and graph khop --resident, as
    # subprocesses on the card
    cli_dir = os.path.join(ROOT, "build", "cli")
    os.makedirs(cli_dir, exist_ok=True)
    cli = [sys.executable, "-m", "binary_spgemm_tpu_torch.cli"]
    paths = {name: os.path.join(cli_dir, f"{name}.mtx") for name in ("closure-in", "bench",
                                                                     "closure-out")}
    t0 = time.perf_counter()
    for path, (n_, d_, seed_) in ((paths["closure-in"], CLOSURE), (paths["bench"], (N, D, SEED))):
        subprocess.run([*cli, "gen", path, "-n", str(n_), "-d", str(d_), "--seed", str(seed_)],
                       cwd=ROOT, check=True, capture_output=True, text=True, timeout=300)
    procs = {
        "closure": subprocess.Popen([*cli, "graph", paths["closure-in"], "closure",
                                     "--no-transpose", "--out", paths["closure-out"]],
                                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True),
        "khop": subprocess.Popen([*cli, "graph", paths["bench"], "khop", "--resident",
                                  "--no-transpose"], cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)}
    try:
        res = {k: p.communicate(timeout=600) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        check(p.returncode == 0, f"CLI graph {k} exited {p.returncode}: {res[k][1][-2000:]}")
    cli_s = time.perf_counter() - t0
    closure_line = res["closure"][0].strip().splitlines()[-1]
    khop_line = res["khop"][0].strip().splitlines()[-1]
    check(read_pattern(paths["closure-out"], transpose=False).equals(want),
          "the CLI's closure differs from (d)'s")
    check(khop_line == f"khop: shape=({N}, {N}) nnz={EXPECTED_NNZ}",
          f"the CLI's k-hop printed {khop_line!r}")
    print(f"CLI (gen x2, then graph closure and graph khop --resident at once): "
          f"{cli_s:.2f} s; {closure_line!r}: the written file equals (d)'s closure; "
          f"{khop_line!r}: (c)'s nnz")
    out["cli_s"] = cli_s
    return out


# phases 20-21: the bench config through dist_spgemm at every B layout and
# engine, the ranks phase 21 runs over gloo on the one card, and the JAX
# dryrun's scale (A = 128 x 128)
DIST_PAIRS = [(lay, eng) for lay in ("replicated", "sharded", "ring") for eng in ("esc", "ell")]
GLOO_RANKS = (2, 4)
DIST_TIMEOUT_S = 600.0
# the dryrun's wide-column product at d = 16: BCSR.random(n, n, d, seed) times
# BCSR.random(n, 2^24, d, seed + 1); its plan's rows of 12,288 slots put
# each rank's two sorts on K1's wide kernel (the bench's rows are past K1)
WIDE_COL = (8192, 1 << 24, 16.0, 11)


def digest(m, counts=None) -> str:
    """A product's identity across processes: the hash of its shape,
    row pointers (as int64), column indices and, for a counting product,
    its counts (as int64)."""
    import hashlib

    h = hashlib.sha256(repr(tuple(m.shape)).encode())
    h.update(np.asarray(m.indptr, np.int64).tobytes())
    h.update(np.asarray(m.indices, np.int32).tobytes())
    if counts is not None:
        h.update(np.asarray(counts, np.int64).tobytes())
    return h.hexdigest()


def result_identity(res) -> tuple[str, int]:
    """``(digest, size)`` of a distributed call's result: a ``BCSR`` (size
    its nnz), a counting product's ``(BCSR, counts)`` (its nnz) or a
    triangle count (the count itself)."""
    if isinstance(res, int):
        return f"{res} triangles", res
    if isinstance(res, tuple):
        return digest(*res), res[0].nnz
    return digest(res), res.nnz


def local_product(path: str, b, n: int, *, mesh):
    """``dist_spgemm_from_local``: this rank reads only its rows of ``path``
    (rows-balanced bounds) and multiplies them by the replicated B."""
    from binary_spgemm_tpu_torch.io.mmio import read_pattern
    from binary_spgemm_tpu_torch.parallel import multihost
    from binary_spgemm_tpu_torch.parallel.mesh import partition_rows

    bounds = partition_rows(np.ones(n), mesh.size, balance="rows")
    lo, hi = multihost.process_row_range(bounds, mesh)
    a_local = read_pattern(path, transpose=False, row_range=(lo, hi))
    check(a_local.shape == (hi - lo, b.n_rows), f"rank {mesh.rank} read {a_local.shape}")
    return multihost.dist_spgemm_from_local(a_local, bounds, b, mesh)


def dist_rank(mesh, calls) -> list[dict]:
    """One rank of phases 20-21: each call ``(label, fn, args, kwargs)`` as
    ``fn(*args, mesh=mesh, **kwargs)``, with K1's, P3's and P4's launch
    counts, the sort routes, the collectives' counters and the peak device
    memory set to 0 just before and read just after (a synchronize each
    side of the host-clock wall).  Every step handed to assembly (counts
    payload included), every triangle step's sums before the all-reduce and
    every one-sort state handed to the final pull must be on the card; a
    one-sort call counts its products (the closure's rounds) and the stream
    lengths it compacts.  Returns per call
    those readings and the result's identity (:func:`result_identity`; for
    the dryrun its ``(path, ok)`` list), and a closure's rounds and
    compactions."""
    import torch

    from binary_spgemm_tpu_torch.ops import bitonic, gather
    from binary_spgemm_tpu_torch.parallel import comm
    from binary_spgemm_tpu_torch.parallel import dist_onesort as do
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as dm

    check(mesh.device.type == "cuda", f"rank {mesh.rank} computes on {mesh.device}")
    k1, routes = bitonic.bitonic_sort_rows, bitonic.sort_rows.routes
    on_card = []
    assemble, group_sum, pull = dm._assemble, dm._group_sum, do._pull
    product, compact = do._dist_product, do._dist_compact
    onesort = {"products": 0, "compactions": []}

    def counted_product(*args, **kwargs):
        onesort["products"] += 1
        return product(*args, **kwargs)

    def counted_compact(state, **kwargs):
        onesort["compactions"].append(state[0].shape[0])
        return compact(state, **kwargs)

    def assemble_on_card(step, sub_bounds, shape, mesh_):
        held = (step.c_ptr, step.c_idx, step.nnz) + (() if step.cnt is None else (step.cnt,))
        on_card.append(all(t.is_cuda for t in held))
        return assemble(step, sub_bounds, shape, mesh_)

    def group_sum_on_card(sums, mesh_):
        on_card.append(sums.is_cuda)
        return group_sum(sums, mesh_)

    def pull_on_card(state, *rest):
        on_card.append(all(t.is_cuda for t in state))
        return pull(state, *rest)

    dm._assemble, dm._group_sum, do._pull = assemble_on_card, group_sum_on_card, pull_on_card
    do._dist_product, do._dist_compact = counted_product, counted_compact
    out = []
    for label, fn, args, kwargs in calls:
        k1.launches = gather.class_gather.launches = gather.class_gather_keys.launches = 0
        for counts in (k1.launches_by_variant, routes):
            for key in counts:
                counts[key] = 0
        comm.reset_counters()
        on_card.clear()
        onesort.update(products=0, compactions=[])
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        t0 = time.perf_counter()
        res = fn(*args, mesh=mesh, **kwargs)
        torch.cuda.synchronize(mesh.device)
        rec = {"label": label, "rank": mesh.rank, "s": time.perf_counter() - t0,
               "k1": k1.launches, "k1_by_variant": dict(k1.launches_by_variant),
               "p3": gather.class_gather.launches, "p4": gather.class_gather_keys.launches,
               "routes": dict(routes), "comm": dict(comm.counters),
               "peak_mib": torch.cuda.max_memory_allocated(mesh.device) / 2**20,
               "on_card": list(on_card)}
        if isinstance(res, list):
            rec["checks"] = res
        else:
            rec["digest"], rec["nnz"] = result_identity(res)
        if onesort["products"]:  # the closure's rounds, or k-hop's products
            rec["rounds"], rec["compactions"] = onesort["products"], onesort["compactions"]
        out.append(rec)
    return out


def ell_sorts(api, x, y, S: int, *, b_layout: str = "replicated", bits: int = 0,
              plain: bool = True) -> dict:
    """What one rank's ELL step must read of ``sort_rows`` and K1, from the
    plan every rank makes alike (made here in the parent): the rank's
    sub-chunks form one ``[C, sort_pad]`` stack, sorted twice.  Keys that do
    not pack (``bits`` the join's extra key bits) sort as int64 pairs,
    outside ``sort_rows``; rows past K1's window take ``torch.sort``; else
    K1, for the plain product (rows of exactly ``sort_pad`` slots) by the
    variant ``k1_variant`` picks.  ``routes`` and ``k1_by_variant`` are
    ``None`` where only their totals are known (a join's rows add the side
    operands' slots to ``sort_pad``)."""
    from binary_spgemm_tpu_torch.parallel.mesh import partition_rows

    sp, bitonic, dist = api["spgemm_mod"], api["bitonic"], api["dist"]
    rf = sp.row_flops(x, y)
    plan = dist._shard_ell_operands(x, y, S, partition_rows(rf, S), rf, b_tables=b_layout,
                                    extra_key_bits=bits, allow_batched=plain)
    rows_pad, sort_pad = plan[5], plan[6]
    zero = {v: 0 for v in bitonic.bitonic_sort_rows.launches_by_variant}
    out = {"sort_pad": sort_pad, "C": plan[7].shape[1] - 1, "routes": None,
           "k1_by_variant": None}
    if not sp.packable(rows_pad, (y.n_cols << bits) + (1 << bits) - 1):
        out.update(routes={"k1": 0, "torch_sort": 0}, k1_by_variant=zero)
    elif sort_pad > bitonic.MAX_L:
        out.update(routes={"k1": 0, "torch_sort": 2}, k1_by_variant=zero)
    elif plain:
        out.update(routes={"k1": 2, "torch_sort": 0},
                   k1_by_variant={**zero, bitonic.k1_variant(sort_pad): 2})
    return out


def count_sorts(api, x, y, S: int, *, bits: int = 0, mask=None) -> dict:
    """:func:`ell_sorts` of a counting step: one key sort a stack through
    ``sort_rows`` (the payload sorts are ``torch.sort`` calls outside it),
    of rows of ``sort_pad`` slots, or ``sort_pad`` plus the mask pad for the
    triangles' tagged sort (``mask`` the graph itself), from the plan every
    rank makes alike (the counting plans are never batched)."""
    from binary_spgemm_tpu_torch.parallel.mesh import partition_rows

    sp, bitonic, dist = api["spgemm_mod"], api["bitonic"], api["dist"]
    rf = sp.row_flops(x, y)
    plan = dist._shard_ell_operands(x, y, S, partition_rows(rf, S), rf, extra_key_bits=bits)
    rows_pad, sort_pad = plan[5], plan[6]
    L = sort_pad
    if mask is not None:
        L += dist._shard_ell_csr(mask, plan[7], rows_pad)[1].shape[-1]
    zero = {v: 0 for v in bitonic.bitonic_sort_rows.launches_by_variant}
    out = {"sort_pad": L, "C": plan[7].shape[1] - 1}
    if not sp.packable(rows_pad, (y.n_cols << bits) + (1 << bits) - 1):
        out.update(routes={"k1": 0, "torch_sort": 0}, k1_by_variant=zero)
    elif L > bitonic.MAX_L:
        out.update(routes={"k1": 0, "torch_sort": 1}, k1_by_variant=zero)
    else:
        out.update(routes={"k1": 1, "torch_sort": 0},
                   k1_by_variant={**zero, bitonic.k1_variant(L): 1})
    return out


def check_sorts(rec: dict, want: dict | None, where: str) -> None:
    """Hold a rank's ``sort_rows`` routes and K1 launches against
    :func:`ell_sorts` (``None``: a path that sorts outside ``sort_rows``).
    Every K1 route must launch one kernel on the card."""
    if want is None:
        want = {"routes": {"k1": 0, "torch_sort": 0}, "k1_by_variant": None}
    check(rec["k1"] == rec["routes"]["k1"],
          f"{where}: K1 launched {rec['k1']} times for {rec['routes']['k1']} K1 routes")
    if want["routes"] is None:
        check(sum(rec["routes"].values()) == 2,
              f"{where}: sort routes {rec['routes']}, not two sorts of one stack")
    else:
        check(rec["routes"] == want["routes"],
              f"{where}: sort routes {rec['routes']}, the plan (sort_pad "
              f"{want.get('sort_pad')}) gives {want['routes']}")
    if want["k1_by_variant"] is not None:
        check(rec["k1_by_variant"] == want["k1_by_variant"],
              f"{where}: K1 by variant {rec['k1_by_variant']}, the plan (sort_pad "
              f"{want.get('sort_pad')}) gives {want['k1_by_variant']}")


def dist_report(runs: list[list[dict]], want: dict, backend: str, sorts: dict) -> dict:
    """Check and print every rank's readings of one launch; ``want`` maps a
    call's label to ``(digest, nnz, gathers)`` of the single-card product,
    ``gathers`` whether the path is an ELL one (P3 or P4 must launch), and
    ``sorts`` to its :func:`ell_sorts` (missing: no ``sort_rows`` call).
    Returns ``{label: {"k1": [...], "k1_wide": [...], "p3": [...], "p4":
    [...], "s": [...]}}`` over the ranks."""
    S = len(runs)
    by_label: dict = {}
    for r, recs in enumerate(runs):
        for rec in recs:
            label = rec["label"]
            check(rec["on_card"] and all(rec["on_card"]),
                  f"S={S} rank {r} {label}: a step held tensors off the card")
            if "checks" in rec:
                bad = [name for name, ok in rec["checks"] if not ok]
                check(not bad, f"S={S} rank {r} dryrun mismatches: {bad}")
                check(rec["k1"] > 0 and rec["p3"] + rec["p4"] > 0,
                      f"S={S} rank {r}: the dryrun launched K1 {rec['k1']}, P3 "
                      f"{rec['p3']}, P4 {rec['p4']}")
                check(rec["k1"] == rec["routes"]["k1"],
                      f"S={S} rank {r}: the dryrun launched K1 {rec['k1']} times for "
                      f"{rec['routes']['k1']} K1 routes")
                result = f"{len(rec['checks'])} paths bit-exact"
            else:
                d, nnz, gathers = want[label]
                check(rec["digest"] == d and rec["nnz"] == nnz,
                      f"S={S} rank {r} {label}: result {rec['nnz']} (want {nnz}), "
                      "not the single-card one")
                if gathers:
                    check(rec["p3"] + rec["p4"] > 0,
                          f"S={S} rank {r} {label}: no P3/P4 launch on an ELL path")
                check_sorts(rec, sorts.get(label), f"S={S} rank {r} {label}")
                result = (d if d.endswith("triangles") else f"nnz {rec['nnz']}") + " bit-exact"
                if "rounds" in rec:
                    result += (f", {rec['rounds']} one-sort products, compactions of "
                               f"{rec['compactions']} slots")
            print(f"  S={S} ({backend}) rank {r} {label}: {result}; {rec['s']:.3f} s on "
                  f"the host clock; K1 {rec['k1']} {rec['k1_by_variant']}, P3 {rec['p3']}, "
                  f"P4 {rec['p4']}, sort routes {rec['routes']}; comm {rec['comm']}; peak "
                  f"device memory {rec['peak_mib']:.1f} MiB")
            row = by_label.setdefault(label, {"k1": [], "k1_wide": [], "p3": [], "p4": [],
                                              "s": []})
            for key in ("k1", "p3", "p4", "s"):
                row[key].append(rec[key])
            row["k1_wide"].append(rec["k1_by_variant"]["wide"])
    return by_label


def dist_phases(torch, card: str, *, api, a, c, op_results, count_results, symmetric,
                closure) -> dict:
    """Phases 20 and 21: the distributed layer on the card.  ``a`` and ``c``
    are phase 5's A and C = A·A (bit-exact against scipy), ``op_results``
    phase 17's single-card op family products, ``count_results`` phase 18's
    single-card counting products, ``symmetric`` its symmetric bench graph
    and ``closure`` phase 19's closure input and its closure (scipy's)."""
    dist, dryrun, launch = api["dist"], api["dryrun"], api["launch"]
    dist_onesort, graph = api["dist_onesort"], api["graph"]
    want = {f"bench dist_spgemm[{lay},{eng}]": (digest(c), c.nnz, eng == "ell")
            for lay, eng in DIST_PAIRS}
    # the counting family, the triangles, the closure and k-hop: each held to
    # the single-card result (phases 18 and 19), on every rank
    count_calls = []
    for eng in ("esc", "ell"):
        label = f"bench dist_spgemm_counts[{eng}]"
        want[label] = (*result_identity(count_results["counts"]), eng == "ell")
        count_calls.append((label, dist.dist_spgemm_counts, (a, a), {"engine": eng}))
    label = "bench dist_masked_spgemm_counts(A, A, A)"
    want[label] = (*result_identity(count_results["masked counts"]), True)
    count_calls.append((label, dist.dist_masked_spgemm_counts, (a, a, a), {}))
    for eng in ("esc", "ell"):
        label = f"bench symmetric dist_triangle_count[{eng}]"
        want[label] = (*result_identity(TRIANGLES["bench"][2]), eng == "ell")
        count_calls.append((label, dist.dist_triangle_count, (symmetric,), {"engine": eng}))
    m, m_closure = closure
    label = "closure input dist_transitive_closure"
    want[label] = (*result_identity(m_closure), False)
    count_calls.append((label, dist_onesort.dist_transitive_closure, (m,), {}))
    ms = m.to_scipy()
    power = ms
    for k in (2, 3):
        # the single-card k-hop (the resident one-sort route), held to scipy
        power = ((power @ ms) > 0).astype(np.int8).tocsr()
        power.sort_indices()
        single = graph.k_hop(m, k, resident=True)
        check(single.equals(api["BCSR"](power.indptr, power.indices, power.shape)),
              f"single-card k_hop(closure input, {k}) differs from scipy's")
        label = f"closure input dist_k_hop(A, {k})"
        want[label] = (*result_identity(single), False)
        count_calls.append((label, dist_onesort.dist_k_hop, (m,), {"k": k}))
        print(f"single-card k_hop(closure input, {k}): {single.nnz} nnz, equal to scipy's")
    n_w, m_w, d_w, seed_w = WIDE_COL
    wa = api["BCSR"].random(n_w, n_w, d_w, seed=seed_w)
    wb = api["BCSR"].random(n_w, m_w, d_w, seed=seed_w + 1)
    wide_label = f"wide-column dist_spgemm[replicated,ell] ({n_w} x 2^{m_w.bit_length() - 1})"
    wc = api["spgemm_oracle"](wa, wb)
    want[wide_label] = (digest(wc), wc.nnz, True)
    wide_call = (wide_label, dist.dist_spgemm, (wa, wb), {"engine": "ell"})
    spgemm_calls = [(f"bench dist_spgemm[{lay},{eng}]", dist.dist_spgemm, (a, a),
                     {"b_layout": lay, "engine": eng}) for lay, eng in DIST_PAIRS]

    def plans(S: int) -> dict:
        """:func:`ell_sorts` of every ELL call this phase makes at ``S``."""
        got = {f"bench dist_spgemm[{lay},ell]": ell_sorts(api, a, a, S, b_layout=lay)
               for lay in ("replicated", "sharded")}
        got[wide_label] = ell_sorts(api, wa, wb, S)
        if S in (1, 4):
            got["bench dist_spgemm_counts[ell]"] = count_sorts(api, a, a, S)
            got["bench dist_masked_spgemm_counts(A, A, A)"] = count_sorts(api, a, a, S,
                                                                          bits=1)
            got["bench symmetric dist_triangle_count[ell]"] = count_sorts(
                api, symmetric, symmetric, S, bits=1, mask=symmetric)
        if S == 2:
            for label, bits in (("bench dist_masked_spgemm(A, A, A)", 1),
                                ("bench dist_spgemm_or(A, A, A)", 0),
                                ("bench dist_spgemm_or(A, A, A, mask=A)", 2)):
                got[label] = ell_sorts(api, a, a, S, bits=bits, plain=False)
        for label, p in got.items():
            print(f"  plan at S={S}, {label}: C {p['C']}, sort_pad {p['sort_pad']}; "
                  f"per rank sort routes {p['routes'] or 'two'}, K1 "
                  f"{p['k1_by_variant'] or 'as routed'}")
        return got

    out = {}

    phase("20. the distributed layer over NCCL: one rank")
    t0 = time.perf_counter()
    runs = launch(dist_rank, 1, spgemm_calls + [wide_call] + count_calls, device="cuda",
                  timeout=DIST_TIMEOUT_S)
    print(f"1 rank over NCCL: {time.perf_counter() - t0:.2f} s on the host clock, "
          f"rank start included; {card}")
    out["S=1 nccl"] = dist_report(runs, want, "nccl", plans(1))

    phase("21. the distributed layer over gloo: 2 and 4 ranks on one card")
    print("ranks share the one card, so these walls are not a scaling curve")
    path = os.path.join(ROOT, "build", "dist_bench.mtx")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    api["write_pattern"](path, a)
    # the op family's auto engine takes the ELL step on the bench config;
    # spm_or and the sharded ingest's product are ESC-form
    for label, key, gathers in (("bench dist_masked_spgemm(A, A, A)", "masked", True),
                                ("bench dist_spgemm_or(A, A, A)", "or", True),
                                ("bench dist_spgemm_or(A, A, A, mask=A)", "or-masked", True),
                                ("bench dist_spm_or(A, C)", "or", False)):
        want[label] = (digest(op_results[key]), op_results[key].nnz, gathers)
    want["bench dist_spgemm_from_local (rows from the .mtx)"] = (digest(c), c.nnz, False)
    calls = {
        4: spgemm_calls + [wide_call] + count_calls
        + [(f"dryrun ({len(dryrun.PATHS)} paths, A = 128 x 128)", dryrun.dryrun_paths, (),
            {})],
        2: [("bench dist_masked_spgemm(A, A, A)", dist.dist_masked_spgemm, (a, a, a), {}),
            ("bench dist_spgemm_or(A, A, A)", dist.dist_spgemm_or, (a, a, a), {}),
            ("bench dist_spgemm_or(A, A, A, mask=A)", dist.dist_spgemm_or, (a, a, a),
             {"mask": a}),
            ("bench dist_spm_or(A, C)", dist.dist_spm_or, (a, c), {}),
            ("bench dist_spgemm_from_local (rows from the .mtx)", local_product,
             (path, a, a.n_rows), {}), wide_call],
    }
    for S in GLOO_RANKS:
        t0 = time.perf_counter()
        runs = launch(dist_rank, S, calls[S], device="cuda", timeout=DIST_TIMEOUT_S)
        print(f"{S} ranks over gloo on one card: {time.perf_counter() - t0:.2f} s on the "
              f"host clock, rank start included; {card}")
        out[f"S={S} gloo"] = dist_report(runs, want, "gloo", plans(S))
    return out  # phase 22 reads the .mtx, then removes it


def launches_on(dist: dict, key: str) -> dict:
    """``{"S=... backend": {label: [launches per rank]}}`` of one kernel."""
    return {run: {label: row[key] for label, row in rows.items()}
            for run, rows in dist.items()}


# phase 22: the bench config's set-up on record before the native host tier
# (git show 4357949:PERF.md, line 110), the CLI's two --chunk-flops values,
# and the shape that puts K1 in its shared-memory window (L <= 128)
SETUP_ON_RECORD = "1.34-1.40 s (git show 4357949:PERF.md, line 110)"
BENCH_SWEEP = "4194304,16777216"
SMEM_SHAPE = (65536, 128)


def in_turns(fns: dict, rounds: int = 1) -> dict:
    """Host-clock seconds of each ``name: fn`` called in turns, forward then
    back, ``rounds`` times: the fastest call of each, and its result."""
    best, out = {}, {}
    order = list(fns.items())
    for _ in range(rounds):
        for name, fn in order + order[::-1]:
            t0 = time.perf_counter()
            out[name] = fn()
            dt = time.perf_counter() - t0
            best[name] = min(best.get(name, dt), dt)
    return {"s": best, "out": out}


def same_arrays(x, y) -> bool:
    """Equal values of two arrays, or of two equal-length nests of them."""
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(same_arrays(p, q) for p, q in zip(x, y))
    return np.array_equal(np.asarray(x), np.asarray(y))


@contextlib.contextmanager
def numpy_tier(native):
    """A context in which the guarded native helpers return ``None``, as
    past their size guards: every caller runs its numpy branch (the set-up's
    A/B against the native tier)."""
    saved = {name: getattr(native, name)
             for name in ("class_partition", "table_fill", "row_weight")}
    try:
        for name in saved:
            setattr(native, name, lambda *args, **kwargs: None)
        yield
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def native_phase(torch, card: str, *, api, a, a16, av, path: str,
                 device: str = "cuda") -> dict:
    """Phase 22a: each native helper against its numpy branch, array for
    array, both timed in turns (host clock), at full size."""
    native, mmio, ell, host = api["native"], api["mmio"], api["ell"], api["host"]
    bcsr_mod, spgemm_mod = api["bcsr_mod"], api["spgemm_mod"]
    print(f"native library {native._target().name}, {native.threads()} OpenMP threads "
          f"of {os.cpu_count()} cores")
    rows = {}

    def row(label: str, res: dict, equal: bool, **extra) -> None:
        check(equal, f"native {label} differs from its numpy branch")
        rows[label] = {"native_s": res["s"]["native"], "numpy_s": res["s"]["numpy"],
                       **extra}
        print(f"{label}: native {res['s']['native'] * 1e3:.2f} ms, numpy "
              f"{res['s']['numpy'] * 1e3:.2f} ms "
              f"({res['s']['numpy'] / max(res['s']['native'], 1e-9):.1f}x), equal; "
              f"{card}")

    with mmio._open_body(path) as (banner, (n_rows, n_cols, nnz), body):
        fields = mmio._fields(banner)
        res = in_turns({"native": lambda: native.parse_pairs(body, nnz, fields),
                        "numpy": lambda: mmio._parse_numpy(body, nnz, fields)})
        (nr, nc), (pr, pc) = res["out"]["native"], res["out"]["numpy"]
        row("parse_pairs", res, same_arrays((nr, nc), (pr, pc)), entries=nnz,
            bytes=len(body))
    check(nnz == a.nnz and (n_rows, n_cols) == a.shape, f"{path} is not the bench config")
    t0 = time.perf_counter()
    read = api["read_pattern"](path, transpose=False)
    read_s = time.perf_counter() - t0
    check(read.equals(a), "read_pattern of the bench .mtx differs from the bench config")
    rows["read_pattern"] = {"native_s": read_s}
    print(f"read_pattern of {nnz} entries ({os.path.getsize(path)} bytes): "
          f"{read_s * 1e3:.2f} ms, equal to the bench config")
    r0, c0 = nr.astype(np.int64) - 1, nc.astype(np.int32) - 1
    res = in_turns({"native": lambda: native.coo2csr(r0, c0, n_rows),
                    "numpy": lambda: bcsr_mod._coo_to_csr_numpy(r0, c0, n_rows)})
    row("coo2csr", res, same_arrays(res["out"]["native"], res["out"]["numpy"]))
    for label, m in (("bench", a), ("rmat-s16", a16)):
        t0 = time.perf_counter()
        e = ell.EllB.build(m)
        build_s = time.perf_counter() - t0

        def fill():
            tables = [np.empty_like(t) for t in e.tables]
            native.table_fill(m.indptr, m.indices, e.class_of_row, e.pos_in_class,
                              tables, m.n_cols)
            return tables

        res = in_turns({"native": fill,
                        "numpy": lambda: ell._fill_tables_numpy(m, e.class_of_row,
                                                                e.widths)})
        row(f"EllB.build's table fill ({label}, {len(e.widths)} classes; the whole "
            f"build {build_s * 1e3:.2f} ms)", res,
            same_arrays(res["out"]["native"], res["out"]["numpy"])
            and same_arrays(e.tables, res["out"]["numpy"]), build_s=build_s)
        res = in_turns({"native": lambda: ell._build_class_entries(m, e),
                        "numpy": lambda: ell._class_entries_numpy(m, e)})
        row(f"_build_class_entries ({label})", res,
            same_arrays(list(res["out"]["native"]), list(res["out"]["numpy"])))
        blen = np.diff(m.indptr).astype(np.int64)
        res = in_turns({"native": lambda: spgemm_mod.row_flops(m, m),
                        "numpy": lambda: spgemm_mod._row_flops_numpy(m, blen)})
        row(f"row_flops ({label})", res,
            same_arrays(res["out"]["native"], res["out"]["numpy"]))
    for label, fn, plain in (
            ("host_spgemm", lambda: host.host_spgemm(av, av),
             lambda: host._spgemm_numpy(av, av)),
            ("host_masked_spgemm", lambda: host.host_masked_spgemm(av, av, av),
             lambda: host._masked_spgemm_numpy(av, av, av)),
            ("host_spgemm_counts", lambda: host.host_spgemm_counts(av, av),
             lambda: host._spgemm_counts_numpy(av, av))):
        res = in_turns({"native": fn, "numpy": plain}, rounds=3)
        got, want = res["out"]["native"], res["out"]["numpy"]
        if isinstance(got, tuple):
            equal = got[0].equals(want[0]) and same_arrays(got[1], want[1])
        else:
            equal = got.equals(want)
        row(f"{label} (validity-class)", res, equal)

    def setup():
        ex = api["auto_executor"](a, a, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return ex.sort_pad, ex.n_chunks

    def setup_numpy():
        with numpy_tier(native):
            return setup()

    res = in_turns({"native": setup, "numpy": setup_numpy})
    row("set-up: auto_executor(A, A) on the bench config", res,
        res["out"]["native"] == res["out"]["numpy"], on_record=SETUP_ON_RECORD)
    print(f"  (on record before the native tier: {SETUP_ON_RECORD})")
    return rows


def cli_lines(cli, argv: list[str]) -> tuple[list[str], list[str]]:
    """``cli.main(argv)`` in this process: its stdout and stderr lines
    (the call must exit 0)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}: {err.getvalue()}")
    return out.getvalue().splitlines(), err.getvalue().splitlines()


def scaling_cli_rank(mesh, argvs) -> list[list[str]]:
    """One rank of phase 22b's scaling reports: each ``bench --scaling-report``
    through the CLI on this group (rank 0 prints)."""
    from binary_spgemm_tpu_torch import cli

    return [cli_lines(cli, argv)[0] for argv in argvs]


def bench_cli_phase(torch, card: str, *, api, path: str, reset_counts, read_counts,
                    k1_by_variant, routes, e2e_ms: float, device: str = "cuda") -> dict:
    """Phase 22b: ``cli.main(["bench", ...])`` on the bench ``.mtx`` (read as
    written, ``--no-transpose``: the bench config itself)."""
    cli, launch = api["cli"], api["launch"]
    base = ["bench", path, "--no-transpose", "--device", device]
    out = {}

    def record(label, lines, csv_fields=11):
        csv = [line for line in lines if line.count(",") == csv_fields - 1]
        check(csv, f"bench {label} printed no CSV line")
        for line in lines:
            print(f"  {line}")
        out[label] = {"csv": csv}
        return csv

    reset_counts()
    t0 = time.perf_counter()
    lines, _ = cli_lines(cli, base + ["--times", "5", "--json"])
    wall = time.perf_counter() - t0
    launches, variants, sort_routes = read_counts(), dict(k1_by_variant), dict(routes)
    print(f"bench --times 5 --json ({wall:.2f} s with the warm-up): launches "
          f"{launches}, K1 by variant {variants}")
    csv = record("auto", lines)
    rec = json.loads(lines[-1])
    runs = 6  # the warm-up and 5 repeats
    check(rec["output_nnz"] == EXPECTED_NNZ and int(csv[0].split(",")[7]) == EXPECTED_NNZ,
          f"bench output nnz {rec['output_nnz']} != {EXPECTED_NNZ}")
    check(launches["bitonic_sort_rows"] == 16 * runs and variants["reg"] == 16 * runs
          and launches["class_gather_keys"] == 8 * runs
          and launches["class_gather"] == 0 and sort_routes["torch_sort"] == 0,
          f"bench: not 16 register-K1 and 8 P4 launches a run: {launches}, {variants}")
    out["auto"].update(json=rec, launches=launches)
    print(f"bench median {rec['median_s'] * 1e3:.2f} ms (fastest "
          f"{rec['fastest_s'] * 1e3:.2f}) against phase 7's run() + assemble() median "
          f"{e2e_ms:.2f} ms (CUDA events); {card}")

    reset_counts()
    lines, _ = cli_lines(cli, base + ["--times", "3", "--engine", "esc", "--json"])
    launches = read_counts()
    record("esc", lines)
    check(json.loads(lines[-1])["output_nnz"] == EXPECTED_NNZ
          and launches["bitonic_sort_rows"] == 0, f"bench --engine esc: {launches}")
    out["esc"]["json"] = json.loads(lines[-1])

    lines, err = cli_lines(cli, base + ["--times", "3", "--tune", "--json"])
    record("tune", lines)
    check(any(line.startswith("tuned: k=") for line in err)
          and json.loads(lines[-1])["output_nnz"] == EXPECTED_NNZ, "bench --tune")
    print(f"  (stderr) {' '.join(err)}")
    out["tune"]["json"] = json.loads(lines[-1])

    lines, _ = cli_lines(cli, base + ["--times", "2", "--sweep", BENCH_SWEEP])
    csv = record("sweep", lines)
    check([line.split(",")[3] for line in csv] == BENCH_SWEEP.split(",")
          and all(int(line.split(",")[7]) == EXPECTED_NNZ for line in csv),
          f"bench --sweep {BENCH_SWEEP}: {csv}")

    t0 = time.perf_counter()
    lines, _ = cli_lines(cli, base + ["--times", "3", "--devices", "2", "--json"])
    print(f"bench --devices 2 (two gloo ranks on the one card): "
          f"{time.perf_counter() - t0:.2f} s with the rank start; {card}")
    csv = record("devices 2", lines)
    check(csv[0].split(",")[0] == "2" and json.loads(lines[-1])["output_nnz"]
          == EXPECTED_NNZ, f"bench --devices 2: {csv}")
    out["devices 2"]["json"] = json.loads(lines[-1])

    argvs = [base + ["--scaling-report", "--devices", "2", "--times", "3", "--json",
                     "--engine", eng, "--b-layout", lay]
             for eng, lay in (("esc", "replicated"), ("ell", "sharded"))]
    t0 = time.perf_counter()
    reports = launch(scaling_cli_rank, 2, argvs, device=device, timeout=DIST_TIMEOUT_S)
    print(f"bench --scaling-report --devices 2 at esc x replicated and ell x sharded, "
          f"one group of two gloo ranks on the one card: "
          f"{time.perf_counter() - t0:.2f} s with the rank start; {card}")
    check(all(lines == [] for lines in reports[1]), "rank 1 printed a report")
    for (eng, lay), lines in zip((("esc", "replicated"), ("ell", "sharded")), reports[0]):
        print(f"  {lines[-1]}")
        rep = json.loads(lines[-1])
        check(rep["kind"] == "scaling_report" and rep["bit_exact"] is True
              and rep["platform"] == device and [r["devices"] for r in rep["rows"]]
              == [1, 2] and (device == "cpu" or rep["cards"] == torch.cuda.device_count()),
              f"scaling report {eng} x {lay}: {rep}")
        check(all(r["compute_s"] is not None for r in rep["rows"]),
              f"scaling report {eng} x {lay} has no compute-only time")
        out[f"scaling {eng} x {lay}"] = rep
    print("ranks share the one card, so the scaling rows measure card sharing, not "
          "scaling")
    return out


def smem_phase(torch, card: str, *, bitonic, rng) -> dict:
    """Phase 22c: K1's shared-memory kernel in its own window (L <= 128)."""
    k, L = SMEM_SHAPE
    check(bitonic.k1_variant(L) == "smem", f"K1 takes L = {L} with another kernel")
    x = torch.from_numpy(rng.integers(INT32_MIN, INT32_MAX, (k, L), dtype=np.int64,
                                      endpoint=True).astype(np.int32)).to("cuda")
    x[0, :5] = INT32_MAX
    got, want = bitonic.bitonic_sort_rows(x), bitonic.bitonic_sort_rows_plain(x)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want), f"K1 (smem) differs from its plain version at {[k, L]}")
    fns = [("k1", lambda: bitonic.bitonic_sort_rows(x)),
           ("plain", lambda: bitonic.bitonic_sort_rows_plain(x)),
           ("lib", lambda: torch.sort(x, dim=1))]
    for _, fn in fns:
        fn()
    times: dict[str, list[float]] = {}
    for name, fn in fns + fns[::-1]:
        times.setdefault(name, []).append(event_ms(torch, fn, 50))
    t = {name: min(v) for name, v in times.items()}
    bound, bound_by = sort_bound_ms(x.numel(), L)
    print(f"K1 (smem) at {[k, L]}: bit-equal to its plain version; {t['k1']:.4f} ms, "
          f"plain {t['plain']:.4f} ms, torch.sort {t['lib']:.4f} ms, bound "
          f"{bound:.4f} ms ({bound_by}); {card}")
    return {"ms": t["k1"], "plain_ms": t["plain"], "library_ms": t["lib"],
            "bound_ms": bound, "bound_by": bound_by, "shape": [k, L],
            "max_abs_err": err}


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
    from binary_spgemm_tpu_torch import BCSR, _build, auto_executor, native, spgemm
    from binary_spgemm_tpu_torch.benchmarks import k1_wide_shapes
    from binary_spgemm_tpu_torch.ops import (
        bitonic, block_matmul, bsr, ell, gather, host)
    from binary_spgemm_tpu_torch.ops.spgemm import pull_chunk_prefixes
    from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    native.lib()  # the native host tier (a C build with OpenMP)
    print(f"native host tier: {native._target().name} ({' '.join(native.CFLAGS)}) "
          f"in {time.perf_counter() - t0:.2f} s")
    for stem, rec in sorted(_build.build_log.items()):
        print(f"{stem}: nvcc {rec['seconds']:.2f} s")
        for line in rec["ptxas"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print("  " + line.strip())
    if not _build.build_log:
        print("libraries were already built from the same sources")
    # kernels that must keep everything in registers: (source, name, count)
    for stem, kernel, count in (("bitonic", "sort_rows_reg_kernel", 5),
                                ("bitonic", "sort_rows_wide_kernel", 9),
                                ("block_matmul", "grouped_block_matmul_pipe_kernel", 8),
                                ("gather", "class_gather_group_kernel", 2)):
        if stem not in _build.build_log:
            continue
        frames = {name: line for name, line in
                  ptxas_frames(_build.build_log[stem]["ptxas"]).items()
                  if kernel in name}
        check(len(frames) == count,
              f"ptxas reported {len(frames)} {kernel} instantiations, not {count}")
        for name, line in sorted(frames.items()):
            print(f"  {name}: {line}")
            check(line.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                  "0 bytes spill loads"),
                  f"{kernel} {name} uses local memory: {line}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    errs = {"bitonic_sort_rows": 0, "fused_sort_compress": 0, "class_gather": 0,
            "class_gather_keys": 0}

    phase("3. kernels against their plain versions")
    for k, L in [(1024, 3968), (512, 4096), (333, 37), (16, bitonic.MAX_L), (7, 1),
                 (64, 128), (64, 129), (64, 255), (64, 256), (64, 257), (32, 2048),
                 (16, 4095), (16, 4097), (16, bitonic.WIDE_SHORT_L),
                 (16, bitonic.WIDE_SHORT_L + 1), (16, 8192), (16, 8193), (16, 16384),
                 (16, 16385), (8, 32767)]:
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
            variant = (f" ({bitonic.k1_variant(L)})"
                       if name == "bitonic_sort_rows" else "")
            print(f"{name}{variant} [{k}, {L}]: bit-equal")
    # K1's wide kernel at every block shape built, the ones wide_block does
    # not pick for this L too (benchmarks/k1_wide_shapes.py times them)
    for log_p, log_ns in k1_wide_shapes.LOG_N.items():
        for log_n in log_ns:
            L = (1 << log_p) - 3
            xt = torch.from_numpy(rng.integers(INT32_MIN, INT32_MAX, (8, L), dtype=np.int64,
                                               endpoint=True).astype(np.int32)).to(dev)
            got = k1_wide_shapes.wide_shape(xt, log_n)
            want = bitonic.bitonic_sort_rows_plain(xt)
            torch.cuda.synchronize()
            errs["bitonic_sort_rows"] = max(errs["bitonic_sort_rows"],
                                            int((got.long() - want.long()).abs().max()))
            check(torch.equal(got, want), f"K1's wide kernel at 2^{log_n} slots a thread "
                                          f"differs at [8, {L}]")
            print(f"bitonic_sort_rows (wide, {(1 << log_p) >> log_n} x {1 << log_n}) "
                  f"[8, {L}]: bit-equal")

    phase("4. P3 and P4 against their plain versions")
    for w in GATHER_WIDTHS:
        g, pad = (3, 6) if w == 10240 else (64, 45)
        table, pos, rows, rp, ncol = gather_case(torch, rng, w, g, pad)
        shift = int(ncol).bit_length()
        want_r, want_c = gather.class_gather_plain(table, pos, rows, rp, ncol)
        want_k = gather.class_gather_keys_plain(table, pos, rows, rp, ncol, shift)
        got_r, got_c = gather.class_gather(table, pos, rows, rp, ncol)
        got_k = gather.class_gather_keys(table, pos, rows, rp, ncol, shift)
        # the same from column slices of wider inputs, into a column span of a
        # wider stream
        wide = [torch.zeros((g, pad + 3), dtype=torch.int32, device=dev)
                for _ in range(2)]
        wide[0][:, 3:], wide[1][:, 3:] = pos, rows
        col0, span = 11, pad * w
        outs = [torch.full((g, span + 20), -7, dtype=torch.int32, device=dev)
                for _ in range(3)]
        gather.class_gather(table, wide[0][:, 3:], wide[1][:, 3:], rp, ncol,
                            out=outs[:2], col0=col0)
        gather.class_gather_keys(table, wide[0][:, 3:], wide[1][:, 3:], rp, ncol,
                                 shift, out=outs[2], col0=col0)
        torch.cuda.synchronize()
        for name, got, want in (("class_gather", got_r, want_r),
                                ("class_gather", got_c, want_c),
                                ("class_gather_keys", got_k, want_k)):
            errs[name] = max(errs[name], int((got.long() - want.long()).abs().max()))
            check(torch.equal(got, want), f"{name} differs at w={w}")
        for o, want in zip(outs, (want_r, want_c, want_k)):
            check(torch.equal(o[:, col0 : col0 + span], want)
                  and bool((o[:, :col0] == -7).all())
                  and bool((o[:, col0 + span :] == -7).all()),
                  f"P3/P4 into a column span differ at w={w}")
        check(bool((want_r == rp).any()), "no sentinel slot in the case")
        print(f"P3 and P4 [{g}, {pad}] x w={w} (positions out of range, sentinel "
              f"rows, column slices in, column span out): bit-equal")
    n3, n4 = gather.class_gather.launches, gather.class_gather_keys.launches
    for g, pad in ((0, 5), (4, 0)):
        z = torch.zeros((g, pad), dtype=torch.int32, device=dev)
        table = torch.zeros((4, 3), dtype=torch.int32, device=dev)
        check(gather.class_gather(table, z, z, 8, 100)[0].shape == (g, 3 * pad)
              and gather.class_gather_keys(table, z, z, 8, 100, 7).shape == (g, 3 * pad),
              "empty group shapes")
    check((gather.class_gather.launches, gather.class_gather_keys.launches) == (n3, n4),
          "an empty group launched a gather")
    print("P3 and P4 on empty groups (g = 0, pad = 0): no launch")
    # the group entry points: every gathered class of a dispatch group in one
    # launch (two past GROUP_CAP classes)
    over_cap = rng.integers(1, 50, gather.GROUP_CAP + 11).tolist()
    shift = int(1000).bit_length()
    for label, widths, g, pad in (
            ("widths 1-200", [1, 2, 3, 5, 7, 16, 40, 200], 64, 45),
            ("w=10240 between two narrow classes", [3, 10240, 5], 3, 6),
            (f"{len(over_cap)} classes, past the cap of {gather.GROUP_CAP}", over_cap, 4, 9)):
        classes, width = group_case(torch, rng, widths, g, pad)
        launches = -(-len(widths) // gather.GROUP_CAP)
        want = [torch.full((g, width), -7, dtype=torch.int32, device=dev)
                for _ in range(3)]
        gather.class_gather_group_plain(classes, 8, 1000, want[:2])
        gather.class_gather_keys_group_plain(classes, 8, 1000, shift, want[2])
        check(bool((want[0] == 8).any()), "no sentinel slot in the group case")
        outs = [torch.full((g, width), -7, dtype=torch.int32, device=dev)
                for _ in range(3)]
        n3, n4 = gather.class_gather.launches, gather.class_gather_keys.launches
        gather.class_gather_group(classes, 8, 1000, outs[:2])
        gather.class_gather_keys_group(classes, 8, 1000, shift, outs[2])
        torch.cuda.synchronize()
        check((gather.class_gather.launches - n3, gather.class_gather_keys.launches - n4)
              == (launches, launches),
              f"group gathers, {label}: not {launches} launch(es) each")
        for name, got, w_ in (("class_gather", outs[0], want[0]),
                              ("class_gather", outs[1], want[1]),
                              ("class_gather_keys", outs[2], want[2])):
            errs[name] = max(errs[name], int((got.long() - w_.long()).abs().max()))
            check(torch.equal(got, w_), f"{name} group differs, {label}")
        print(f"P3 and P4 groups, {label} ([{g}, {pad}] a class, first span at column "
              f"{classes[0][3]}, row stride {width}, inputs column slices): {launches} "
              f"launch(es) each, bit-equal")
    n3, n4 = gather.class_gather.launches, gather.class_gather_keys.launches
    key = torch.full((4, 10), -7, dtype=torch.int32, device=dev)
    empty = torch.zeros((4, 0), dtype=torch.int32, device=dev)
    for classes in ([], [(torch.zeros((3, 2), dtype=torch.int32, device=dev), empty,
                          empty, 1)]):
        gather.class_gather_group(classes, 8, 1000, (key, key.clone()))
        gather.class_gather_keys_group(classes, 8, 1000, 10, key)
    check((gather.class_gather.launches, gather.class_gather_keys.launches) == (n3, n4)
          and bool((key == -7).all()), "a group with no gathered class launched a gather")
    print("P3 and P4 groups with no gathered class: no launch")

    counters = {
        "bitonic_sort_rows": bitonic.bitonic_sort_rows,
        "bitonic_network_rows": bitonic.bitonic_network_rows,
        "fused_sort_compress": bitonic.fused_sort_compress,
        "grouped_block_matmul": block_matmul.grouped_block_matmul,
        "class_gather": gather.class_gather,
        "class_gather_keys": gather.class_gather_keys,
    }
    routes = bitonic.sort_rows.routes

    k1_by_variant = bitonic.bitonic_sort_rows.launches_by_variant
    k3_by_variant = block_matmul.grouped_block_matmul.launches_by_variant

    def reset_counts() -> None:
        for fn in counters.values():
            fn.launches = 0
        for by_variant in (k1_by_variant, k3_by_variant, routes):
            for variant in by_variant:
                by_variant[variant] = 0

    def read_counts() -> dict[str, int]:
        return {name: fn.launches for name, fn in counters.items()}

    phase("5. main path")
    reset_counts()
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
    launches = read_counts()
    k1_variants = dict(k1_by_variant)
    main_routes = dict(routes)
    check(isinstance(ex, ell.EllSpGEMMExecutor) and ex.batched, "not batched")
    print(f"input nnz {a.nnz}; plan + stage {plan_s:.2f} s: k={ex.n_chunks} "
          f"groups={ex.n_groups}x{ex.group_size} rows_pad={ex.rows_pad} "
          f"widths={ex.widths} pads={ex.pads} sort_pad={ex.sort_pad} "
          f"out_pad={ex.out_pad}")
    print(f"peak device memory through run(): {peak / 2**20:.1f} MiB")
    print(f"launches in auto_executor -> run() -> assemble(): {launches}; "
          f"K1 by variant {k1_variants}")
    check(launches["bitonic_sort_rows"] == 2 * ex.n_groups,
          f"K1 launched {launches['bitonic_sort_rows']} times, "
          f"expected {2 * ex.n_groups}")
    check(k1_variants == {"reg": 2 * ex.n_groups, "wide": 0, "smem": 0},
          f"K1 variants {k1_variants}: expected the register kernel every time")
    check(launches["grouped_block_matmul"] == 0, "K3 ran on the ELL path")
    gathered_main = sum(s is not None for s in ex.table_shapes)
    check(launches["class_gather_keys"] == group_launches(gather, ex) == ex.n_groups
          and launches["class_gather"] == 0,
          f"P4 launched {launches['class_gather_keys']} times, expected one per "
          f"dispatch group ({ex.n_groups}); P3 {launches['class_gather']} times, "
          f"expected 0")
    check(main_routes == {"k1": 2 * ex.n_groups, "torch_sort": 0},
          f"sort_rows routes {main_routes}")
    print(f"sort_rows routes {main_routes}; P4 launches per run() "
          f"{launches['class_gather_keys']} (one per group, {gathered_main} gathered "
          f"classes each)")
    ref = spgemm_oracle(a, a)
    check(c.equals(ref), "C = A·A differs from scipy")
    check(c.nnz == EXPECTED_NNZ, f"output nnz {c.nnz} != {EXPECTED_NNZ}")
    print(f"C = A·A bit-exact against scipy: output nnz {c.nnz}")

    phase("6. K2 on the main path's key streams")
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

    phase("7. times (CUDA events)")
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
    k1_variant = bitonic.k1_variant(x.shape[1])
    k1 = lambda: bitonic.bitonic_sort_rows(x)
    # K1's shared-memory kernel at the same shape: the kernel it replaced here
    k1_smem = lambda: bitonic._sort_rows_variant(x, "smem")
    k1_plain = lambda: bitonic.bitonic_sort_rows_plain(x)
    k1_lib = lambda: torch.sort(x, dim=1)
    k2 = lambda: bitonic.fused_sort_compress(x, limit)
    k2_plain = lambda: bitonic.fused_sort_compress_plain(x, limit)
    check(torch.equal(k1_smem(), k1_plain()),
          "K1's shared-memory variant differs at the main path's shape")
    for fn in (k1, k1_smem, k1_plain, k1_lib, k2, k2_plain):
        fn()
    times: dict[str, list[float]] = {}
    order = [("k1", k1), ("k1_smem", k1_smem), ("k1_plain", k1_plain),
             ("k1_lib", k1_lib), ("k2", k2), ("k2_plain", k2_plain)]
    for name, fn in order + order[::-1]:  # in turns: forward, then back
        times.setdefault(name, []).append(event_ms(torch, fn, 50))
    t = {name: min(v) for name, v in times.items()}
    bound, bound_by = sort_bound_ms(x.numel(), x.shape[1])
    bound2, bound2_by = sort_bound_ms(x.numel(), x.shape[1], sorts=2)
    shape = list(x.shape)
    print(f"at {shape}: K1 ({k1_variant}) {t['k1']:.4f} ms, K1 (smem) "
          f"{t['k1_smem']:.4f} ms, plain {t['k1_plain']:.4f} ms, "
          f"torch.sort {t['k1_lib']:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
          f"K2 {t['k2']:.4f} ms, plain {t['k2_plain']:.4f} ms, "
          f"bound {bound2:.4f} ms ({bound2_by})")
    # K1 against torch.sort on random int32 rows at other lengths it takes
    k1_shapes = []
    for k, L in [(4096, 256), (2048, 1024), (1024, 2048)]:
        xs = torch.from_numpy(
            rng.integers(INT32_MIN, INT32_MAX, (k, L), dtype=np.int64,
                         endpoint=True).astype(np.int32)).to(dev)
        check(torch.equal(bitonic.bitonic_sort_rows(xs),
                          bitonic.bitonic_sort_rows_plain(xs)),
              f"K1 differs at [{k}, {L}]")
        pair = [("k1", lambda: bitonic.bitonic_sort_rows(xs)),
                ("lib", lambda: torch.sort(xs, dim=1))]
        st: dict[str, list[float]] = {}
        for name, fn in pair + pair[::-1]:
            st.setdefault(name, []).append(event_ms(torch, fn, 50))
        b_ms, b_by = sort_bound_ms(xs.numel(), L)
        row = {"shape": [k, L], "variant": bitonic.k1_variant(L),
               "ms": min(st["k1"]), "library_ms": min(st["lib"]),
               "bound_ms": b_ms, "bound_by": b_by}
        k1_shapes.append(row)
        print(f"at [{k}, {L}] (random int32): K1 ({row['variant']}) "
              f"{row['ms']:.4f} ms, torch.sort {row['library_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")

    gather_main = time_path_gathers(torch, gather, ell, ex, "bench, one dispatch group",
                                    reps=20)

    phase("8. blocked path")
    n_blk, block, bpr, density, seed_blk = BLOCKED
    reset_counts()
    held = torch.cuda.memory_allocated()  # the ELL path's buffers still held
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ab = BCSR.random_blocked(n_blk, block, bpr, density, seed=seed_blk)
    t1 = time.perf_counter()
    bex = auto_executor(ab, ab)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = bex.run()
    torch.cuda.synchronize()
    peak_b = torch.cuda.max_memory_allocated()
    cb = bex.assemble(counts)
    launches_b = read_counts()
    k3_variants = dict(k3_by_variant)
    check(k1_by_variant == {"reg": 0, "wide": 0, "smem": 0},
          f"K1 ran on the blocked path: {k1_by_variant}")
    check(isinstance(bex, bsr.BsrStagedExecutor),
          f"auto_executor took {type(bex).__name__}, not the blocked route")
    print(f"input nnz {ab.nnz}; generator {t1 - t0:.2f} s, auto_executor "
          f"(blocked plan + staging) {t2 - t1:.2f} s: {bex._ex.npairs} pairs "
          f"({bex.n_pairs} padded), {bex.n_out} output blocks, "
          f"{bex._blk_a.n_blocks} A-blocks, tile occupancy "
          f"{bex._blk_a.block_occupancy():.3f}")
    print(f"peak device memory through run(): {(peak_b - held) / 2**20:.1f} MiB "
          f"above the {held / 2**20:.1f} MiB the ELL path still held")
    print(f"launches in auto_executor -> run() -> assemble(): {launches_b}; "
          f"K3 by variant {k3_variants}")
    check(k3_variants == {"pipe": 1, "simple": 0},
          f"K3 variants {k3_variants}: expected the pipe kernel once")
    check((bex._ex.npairs, bex.n_pairs, bex.n_out)
          == (BLOCKED_PAIRS, BLOCKED_PAIRS_PAD, BLOCKED_OUT),
          f"blocked plan {(bex._ex.npairs, bex.n_pairs, bex.n_out)}")
    check(launches_b == {"bitonic_sort_rows": 0, "bitonic_network_rows": 0,
                         "fused_sort_compress": 0, "grouped_block_matmul": 1,
                         "class_gather": 0, "class_gather_keys": 0},
          f"blocked path launches {launches_b}")
    t0 = time.perf_counter()
    ref_b = spgemm_oracle(ab, ab)
    oracle_s = time.perf_counter() - t0
    check(cb.equals(ref_b), "blocked C = A·A differs from scipy")
    check(cb.nnz == BLOCKED_NNZ, f"blocked output nnz {cb.nnz} != {BLOCKED_NNZ}")
    print(f"C = A·A bit-exact against scipy (oracle {oracle_s:.2f} s): "
          f"output nnz {cb.nnz}")
    t0 = time.perf_counter()
    c1 = spgemm(ab, ab)
    one_shot_s = time.perf_counter() - t0
    check(c1.equals(ref_b), "one-shot spgemm differs from scipy")
    check(block_matmul.grouped_block_matmul.launches == 2
          and k3_by_variant == {"pipe": 2, "simple": 0},
          f"one-shot spgemm did not launch K3's pipe kernel exactly once: "
          f"{dict(k3_by_variant)}")
    print(f"one-shot spgemm(a, a): bit-exact, one more K3 launch (pipe), "
          f"{one_shot_s:.2f} s on the host clock (plan, staging, run, assemble)")

    phase("9. K3 against its plain version")
    k3 = block_matmul.grouped_block_matmul
    k3_plain = block_matmul.grouped_block_matmul_plain
    k3_named = block_matmul._grouped_block_matmul_variant
    # run()'s arguments: the staged plan's real pairs; and the whole padded
    # plan, tail included, as the TPU kernel ran it
    npairs = bex._ex.npairs
    plan = [bex._ex.seg, bex._ex.ka, bex._ex.kb, bex._ex.first]
    tiles = [bex._ex.a_dev, bex._ex.b_dev]
    real = [x[:npairs] for x in plan] + tiles
    padded = plan + tiles
    n_out_real = bex.n_out + 1
    cases = [("blocked-32k-b128 plan, run()'s real pairs", real, n_out_real),
             ("blocked-32k-b128 plan, padded tail included", padded, n_out_real)]
    for b, groups, ones, label in (
        (32, [1, 3, 2, 5, 1], False, "b=32"),
        (64, [4, 1, 2], False, "b=64"),
        (100, [3, 1, 2], False, "b=100 (ragged)"),
        (128, [1, 2, 3, 1], False, "b=128"),
        (128, [230, 1, 2], False, "b=128, one block of 230 pairs"),
        (128, [3, 2, 1], True, "b=128, all-ones tiles"),
        (128, [4] * 16, False, "b=128, 64 pairs: no padded tail"),
        (64, rng.integers(1, 4, 4000).tolist(), False,
         "b=64, 4,000 output blocks of 1-3 pairs"),
    ):
        args = k3_case(torch, rng, b, groups, ones=ones)
        cases.append((label, args, len(groups) + 1))
    skips = [0, 2, 0, 3, 1, 0]  # output blocks 0, 2, 5 and the scratch block 6 unvisited
    cases.append(("b=128, pairs skip the first, a middle and the last output blocks",
                  k3_case(torch, rng, 128, skips, tail=False), len(skips) + 1))
    no_pairs = torch.zeros(0, dtype=torch.int32, device=dev)
    cases.append(("b=128, no pairs at all", [no_pairs] * 4 + cases[-1][1][4:], 6))
    err_k3 = 0.0
    for label, args, n_out in cases:
        want = k3_plain(*args, n_out=n_out)
        b = args[4].shape[-1]
        aligned = args[4].data_ptr() % 16 == 0 and args[5].data_ptr() % 16 == 0
        variants = (["pipe"] if block_matmul.k3_variant(b, aligned) == "pipe" else []) + [
            "simple"]
        for variant in variants:
            got = k3_named(*args, n_out=n_out, variant=variant)
            torch.cuda.synchronize()
            if want.numel():
                err_k3 = max(err_k3, float((got - want).abs().max()))
            check(torch.equal(got, want),
                  f"K3 ({variant}) differs from its plain version: {label}")
        check(torch.equal(k3(*args, n_out=n_out), want), f"K3 differs: {label}")
        if label.endswith("no pairs at all"):
            check(not want.any(), "K3's plain version is not zeros without pairs")
        tail = bool((args[0] == n_out - 1).any())
        print(f"K3 {label}: {args[0].shape[0]} pairs, out {tuple(want.shape)}, "
              f"max count {int(want.max())}, scratch block visited {tail}: "
              f"{' and '.join(variants)} equal to the plain version")
    check(torch.equal(k3(*real, n_out=n_out_real), counts), "K3 not deterministic")

    phase("10. blocked path times (CUDA events)")
    for _ in range(3):
        bex.run()
    torch.cuda.synchronize()
    brun_ms = [event_ms(torch, bex.run, 1) for _ in range(30)]
    be2e_ms = [event_ms(torch, lambda: bex.assemble(bex.run()), 1)
               for _ in range(5)]
    print(f"run(): median {statistics.median(brun_ms):.4f} ms, "
          f"fastest {min(brun_ms):.4f} ms, slowest {max(brun_ms):.4f} ms "
          f"({len(brun_ms)} runs)")
    print(f"run() + assemble(): median {statistics.median(be2e_ms):.2f} ms, "
          f"fastest {min(be2e_ms):.2f} ms, slowest {max(be2e_ms):.2f} ms "
          f"({len(be2e_ms)} runs)")
    # assemble() on the host clock: the pull (threshold on the card, copy of
    # the uint8 tiles), the whole blocked assemble (pull + block structure),
    # and the host flattening of the blocked result (to_bcsr)
    pull_b, blk_b, flat_b = [], [], []
    for _ in range(3):
        counts = bex.run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bsr._threshold(counts, bex.n_out)
        t1 = time.perf_counter()
        blk = bex._ex.assemble(counts)
        t2 = time.perf_counter()
        flat = blk.to_bcsr()
        t3 = time.perf_counter()
        check(flat.equals(cb), "split assemble() differs")
        pull_b.append((t1 - t0) * 1e3)
        blk_b.append((t2 - t1) * 1e3)
        flat_b.append((t3 - t2) * 1e3)
    print(f"assemble() split (host clock, median of 3): pull "
          f"{statistics.median(pull_b):.2f} ms, blocked assemble (pull + "
          f"block structure) {statistics.median(blk_b):.2f} ms, host "
          f"flattening to_bcsr {statistics.median(flat_b):.2f} ms")

    profile_run(torch, bex.run, reps=10)

    # the backend="xla" composition at the route's shape: gather + f32
    # torch.bmm + index_add_ over PAIR_CHUNK chunks, plan staged beforehand
    n_out_pad = bsr.pad_bucket(bex.n_out + 1, minimum=2)
    chunks = []
    for p0 in range(0, npairs, bsr.PAIR_CHUNK):
        w = min(bsr.PAIR_CHUNK, npairs - p0)
        ck = [torch.zeros(bsr.PAIR_CHUNK, dtype=torch.int32, device=dev)
              for _ in range(2)]
        cseg = torch.full((bsr.PAIR_CHUNK,), n_out_pad - 1, dtype=torch.int32,
                          device=dev)
        ck[0][:w], ck[1][:w] = real[1][p0 : p0 + w], real[2][p0 : p0 + w]
        cseg[:w] = real[0][p0 : p0 + w]
        chunks.append((ck[0], ck[1], cseg))

    def xla_composition():
        acc = torch.zeros((n_out_pad, block, block), dtype=torch.float32,
                          device=dev)
        for cka, ckb, cseg in chunks:
            bsr._pair_matmul_accumulate(real[4], real[5], cka, ckb, cseg, acc)
        return acc

    check(torch.equal(xla_composition()[: bex.n_out], counts[: bex.n_out]),
          "the xla composition differs from K3")
    k3_fn = lambda: k3(*real, n_out=n_out_real)
    # K3's simple kernel on the same plan: the kernel the pipe kernel replaced here
    k3_simple_fn = lambda: k3_named(*real, n_out=n_out_real, variant="simple")
    k3_padded_fn = lambda: k3(*padded, n_out=n_out_real)
    k3_plain_fn = lambda: k3_plain(*real, n_out=n_out_real)
    k3_variant = block_matmul.k3_variant(
        block, real[4].data_ptr() % 16 == 0 and real[5].data_ptr() % 16 == 0)
    # device time per call, from CUDA-graph replays of 20 calls: the pipe
    # kernel is shorter than its wrapper's host time on a slow host.  The plain
    # version's mask synchronises with the host, so it cannot be captured and
    # is timed over 20 calls back to back.
    ktimers = {name: graph_timer(torch, fn, 20) for name, fn in (
        ("k3", k3_fn), ("k3_simple", k3_simple_fn), ("k3_padded", k3_padded_fn),
        ("xla", xla_composition))}
    k3_plain_fn()
    ktimers["k3_plain"] = lambda: event_ms(torch, k3_plain_fn, 20)
    korder = ["k3", "k3_simple", "k3_padded", "k3_plain", "xla"]
    ktimes: dict[str, list[float]] = {}
    for name in korder + korder[::-1]:  # in turns: forward, then back
        ktimes.setdefault(name, []).append(ktimers[name]())
    kt = {name: min(v) for name, v in ktimes.items()}
    del ktimers  # the graphs' memory
    # writing K3's f32 output alone, as one library call: what the card's memory
    # takes for the biggest part of K3's bytes
    out_ref = torch.empty_like(counts)
    write_ms = min(event_ms(torch, out_ref.zero_, 20) for _ in range(2))
    bound3, bound3_by = k3_bound_ms(
        real[4].shape[0], real[5].shape[0], n_out_real, npairs, block
    )
    shape3 = {"pairs": npairs, "a_tiles": int(real[4].shape[0]),
              "b_tiles": int(real[5].shape[0]), "out": [n_out_real, block, block]}
    print(f"at {shape3}: K3 ({k3_variant}) {kt['k3']:.4f} ms, K3 (simple) "
          f"{kt['k3_simple']:.4f} ms, plain {kt['k3_plain']:.4f} ms, "
          f"xla composition (gather + torch.bmm + index_add_, library calls, "
          f"not one call) {kt['xla']:.4f} ms, bound {bound3:.4f} ms ({bound3_by}); "
          f"K3 on the padded plan ({padded[0].shape[0]} pairs, "
          f"{padded[0].shape[0] - npairs} of them into the scratch block) "
          f"{kt['k3_padded']:.4f} ms; torch zero_ of the f32 output alone "
          f"{write_ms:.4f} ms")
    # long pair groups: one output block's pairs run on one thread block in
    # both kernels, one after another
    n_long, per_long = LONG_GROUPS
    long_args = k3_case(torch, rng, block, [per_long] * n_long, n_tiles=64, tail=False)
    long_pipe = lambda: k3(*long_args, n_out=n_long)
    long_simple = lambda: k3_named(*long_args, n_out=n_long, variant="simple")
    check(torch.equal(long_pipe(), k3_plain(*long_args, n_out=n_long))
          and torch.equal(long_simple(), long_pipe()),
          "K3 differs on the long-group plan")
    ltimers = {"pipe": graph_timer(torch, long_pipe, 20),
               "simple": graph_timer(torch, long_simple, 20)}
    ltimes: dict[str, list[float]] = {}
    for name in ["pipe", "simple", "simple", "pipe"]:
        ltimes.setdefault(name, []).append(ltimers[name]())
    del ltimers
    long_groups = {"ms": min(ltimes["pipe"]), "previous_ms": min(ltimes["simple"]),
                   "pairs": n_long * per_long, "out_blocks": n_long}
    print(f"long groups ({n_long} output blocks x {per_long} pairs, b = {block}, 64 + 64 "
          f"tiles): K3 ({k3_variant}) {long_groups['ms']:.4f} ms, K3 (simple) "
          f"{long_groups['previous_ms']:.4f} ms")

    path_kw = dict(reset_counts=reset_counts, read_counts=read_counts,
                   routes=routes, auto_executor=auto_executor,
                   spgemm_oracle=spgemm_oracle)

    def gathered(ex) -> int:
        return sum(s is not None for s in ex.table_shapes)

    phase("11. rows past K1's window: rmat-s16 (batched)")
    scale, ef, seed_r = RMAT16
    a16 = BCSR.rmat(scale, ef, seed=seed_r)
    ex16, launches16, routes16, times16, c16 = drive_ell_path(
        torch, f"BCSR.rmat({scale}, {ef}, seed={seed_r})", a16, RMAT16_NNZ,
        runs=5, e2e_runs=2, profile_reps=1, **path_kw)
    check(ex16.batched and ex16.sort_pad > bitonic.MAX_L,
          f"rmat-s16: batched {ex16.batched}, sort_pad {ex16.sort_pad}")
    check(routes16 == {"k1": 0, "torch_sort": 2 * ex16.n_groups},
          f"rmat-s16 sort_rows routes {routes16}")
    check(launches16["bitonic_sort_rows"] == 0
          and launches16["class_gather_keys"] == group_launches(gather, ex16)
          == ex16.n_groups and launches16["class_gather"] == 0,
          f"rmat-s16 launches {launches16}")
    print(f"every sort past K1's window went through torch.sort: {routes16}; P4 "
          f"launches per run() {launches16['class_gather_keys']} (one per group, "
          f"{gathered(ex16)} gathered classes each)")
    gather_s16 = time_path_gathers(torch, gather, ell, ex16,
                                   "rmat-s16, one dispatch group", reps=4)
    del ex16  # a16 and its product stay for phase 16's giant route

    phase("12. the unrolled route at full size: rmat-s18-e8 (dealt)")
    scale, ef, seed_r = RMAT18
    t0 = time.perf_counter()
    a18 = BCSR.rmat(scale, ef, seed=seed_r)
    print(f"generator {time.perf_counter() - t0:.2f} s")
    ex18, launches18, routes18, times18, c18 = drive_ell_path(
        torch, f"rmat-s18-e8, BCSR.rmat({scale}, {ef}, seed={seed_r})", a18,
        RMAT18_NNZ, runs=5, e2e_runs=1, profile_reps=1, **path_kw)
    check(not ex18.batched and ex18.row_sets is not None,
          "rmat-s18-e8 did not take the unrolled dealt plan")
    check(launches18["class_gather"] == group_launches(gather, ex18) == ex18.n_groups
          and launches18["class_gather_keys"] == 0
          and launches18["bitonic_sort_rows"] == 0,
          f"rmat-s18-e8 launches {launches18}")
    check(routes18 == {"k1": 0, "torch_sort": 2 * ex18.n_groups},
          f"rmat-s18-e8 sort_rows routes {routes18}")
    print(f"P3 launches per run() {launches18['class_gather']} (one per group, "
          f"{gathered(ex18)} gathered classes each)")
    gather_rmat = time_path_gathers(torch, gather, ell, ex18,
                                    "rmat-s18-e8, one dispatch group", reps=4)
    # the same group by width band, each band one group launch over its classes
    classes18 = group_gathers(ell, ex18, 0)
    bands = {}
    for band, lo, hi in (("w < 32", 0, 32), ("32 <= w < 512", 32, 512),
                         ("w >= 512", 512, 1 << 31)):
        sub = [c for c in classes18 if lo <= c[3] < hi]
        res = time_gathers(torch, gather, sub, ex18.group_size, ex18.rows_pad,
                           ex18.n_cols, ex18.sort_pad, f"rmat-s18-e8 band {band}",
                           reps=4, full=False)
        bands[band] = {"classes": len(sub), "slots": res["shape"]["slots"],
                       "p3_ms": res["t"]["p3"], "p4_ms": res["t"]["p4"],
                       "p3_bound_ms": res["bound3"][0], "p4_bound_ms": res["bound4"][0]}
    del ex18, classes18  # a18 and its product stay for phase 16's ESC run

    phase("13. the unrolled contiguous plan: random 32k")
    n32, d32, seed32 = RAND32K
    a32 = BCSR.random(n32, n32, d32, seed=seed32)
    ex32, launches32, routes32, times32, c32 = drive_ell_path(
        torch, f"BCSR.random({n32}, {n32}, {d32}, seed={seed32})", a32,
        RAND32K_NNZ, runs=10, e2e_runs=3, profile_reps=3, **path_kw)
    check(not ex32.batched and ex32.row_sets is None,
          "random 32k did not take the unrolled contiguous plan")
    check(launches32["class_gather"] == group_launches(gather, ex32) == ex32.n_groups
          and launches32["class_gather_keys"] == 0,
          f"random 32k launches {launches32}")
    print(f"P3 launches per run() {launches32['class_gather']} (one per group, "
          f"{gathered(ex32)} gathered classes each); sort_rows routes {routes32}")
    gather_32k = time_path_gathers(torch, gather, ell, ex32,
                                   "random 32k, one dispatch group", reps=10)
    n3 = gather.class_gather.launches
    t0 = time.perf_counter()
    c1 = spgemm(a32, a32)
    one_shot_s = time.perf_counter() - t0
    check(gather.class_gather.launches - n3 == launches32["class_gather"],
          "one-shot spgemm did not run the unrolled plan")
    check(c1.equals(spgemm_oracle(a32, a32)) and c1.nnz == RAND32K_NNZ,
          "one-shot spgemm differs from scipy")
    print(f"one-shot spgemm(a, a): bit-exact, {one_shot_s:.2f} s on the host "
          f"clock (plan, staging, run, assemble)")
    del ex32, a32, c1, c32

    phase("14. the host engine: validity-class")
    nv, dv, seed_v = VALIDITY
    av = BCSR.random(nv, nv, dv, seed=seed_v)
    served = []
    real_host = host.host_spgemm
    host.host_spgemm = lambda a, b: served.append(1) or real_host(a, b)
    try:
        reset_counts()
        t0 = time.perf_counter()
        cv = spgemm(av, av)
        host_s = time.perf_counter() - t0
        launches_v = read_counts()
    finally:
        host.host_spgemm = real_host
    check(served == [1], "the host engine did not serve validity-class")
    check(not any(launches_v.values()), f"a kernel ran on the host route: {launches_v}")
    check(cv.equals(spgemm_oracle(av, av)) and cv.nnz == VALIDITY_NNZ,
          "validity-class differs from scipy")
    print(f"spgemm on validity-class ({av.nnz} input nnz): served by host_spgemm "
          f"in {host_s * 1e3:.2f} ms on the host clock, no kernel launched, "
          f"bit-exact ({cv.nnz} output nnz)")


    phase("15. P1 and P2, and the sort drivers")
    from binary_spgemm_tpu_torch.benchmarks import (
        ab_wruns, pallas_gather as gather_driver, pallas_sort, sort_rate_table)

    net = bitonic.bitonic_network_rows
    net_plain = bitonic.bitonic_network_rows_plain
    serving = {"bench": launches, "blocked": launches_b, "rmat-s16": launches16,
               "rmat-s18-e8": launches18, "random-32k": launches32,
               "validity-class": launches_v}
    check(not any(v["bitonic_network_rows"] for v in serving.values()),
          f"P1/P2 ran on a serving path: {serving}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err_net = 0
    for k, L in pallas_sort.SHAPES:  # P1's shapes, the whole network
        x = torch.randint(0, 1 << 30, (k, L), dtype=torch.int32, device=dev,
                          generator=gen)
        got, want = net(x, 2), net_plain(x, 2)
        err_net = max(err_net, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want) and torch.equal(got, torch.sort(x, dim=1).values),
              f"P1 differs from its plain version or torch.sort at [{k}, {L}]")
        print(f"P1 [{k}, {L}] ({bitonic.k1_variant(L)}): equal to its plain version "
              f"and torch.sort")
        del x, got, want
    err, n_cases = network_cases(torch, bitonic, ab_wruns, dev, rng)
    err_net = max(err_net, err)
    print(f"the network at L = {NETWORK_LENGTHS} x min_kk = 2, 4, 32, L, 2L x random "
          f"and alternating-run rows: {n_cases} cases equal to the plain version; "
          f"sorted wherever min_kk <= 2w on the runs")
    # P2's input: the driver's shape with every 16-block presorted
    x2 = torch.randint(0, 1 << 30, (ab_wruns.K, ab_wruns.L), dtype=torch.int32,
                       device=dev, generator=gen)
    xp = ab_wruns.alternating_runs(x2, ab_wruns.W)
    skip = 2 * ab_wruns.W
    got, want = net(xp, skip), net_plain(xp, skip)
    check(torch.equal(got, want) and torch.equal(got, torch.sort(x2, dim=1).values),
          "P2 skip-w16 differs from its plain version or torch.sort on its run input")
    print(f"P2 skip-w16 [{ab_wruns.K}, {ab_wruns.L}]: equal to its plain version and "
          f"to torch.sort on the run input")
    del got, want

    drivers = {}
    rows_path = os.path.join(ROOT, "build", "driver_rows.jsonl")
    os.makedirs(os.path.dirname(rows_path), exist_ok=True)
    for name, driver_main, argv in (
            ("pallas_sort", pallas_sort.main, []),
            ("ab_wruns", ab_wruns.main, []),
            ("sort_rate_table", sort_rate_table.main, ["--elems", "27"]),
            ("pallas_gather", gather_driver.main, [])):
        reset_counts()
        t0 = time.perf_counter()
        rows = driver_main(argv + ["--results", rows_path])
        seconds = time.perf_counter() - t0
        drivers[name] = {"rows": rows, "launches": read_counts(), "s": seconds}
        bad = [r for r in rows if r.get("bit_exact") not in (True, "n/a")]
        check(not bad, f"{name}: rows not bit-exact: {bad}")
        print(f"driver {name}: {len(rows)} rows in {seconds:.2f} s, launches "
              f"{drivers[name]['launches']}")
    for name, kernel in (("pallas_sort", "bitonic_network_rows"),
                         ("ab_wruns", "bitonic_network_rows"),
                         ("sort_rate_table", "bitonic_sort_rows"),
                         ("pallas_gather", "class_gather"),
                         ("pallas_gather", "class_gather_keys")):
        check(drivers[name]["launches"][kernel] > 0,
              f"driver {name} did not launch {kernel}")

    def drv(name, **match):
        found = [r for r in drivers[name]["rows"]
                 if all(r.get(key) == v for key, v in match.items())]
        check(len(found) == 1, f"driver {name}: no single row {match}")
        return found[0]

    p1_shapes = []
    for k, L in pallas_sort.SHAPES:
        x = torch.randint(0, 1 << 30, (k, L), dtype=torch.int32, device=dev,
                          generator=gen)
        plain_ms = min(event_ms(torch, lambda: net_plain(x, 2), 1) for _ in range(2))
        b_ms, b_by = sort_bound_ms(k * L, L)
        row = {"shape": [k, L], "variant": bitonic.k1_variant(L),
               "ms": drv("pallas_sort", variant="network", k=k, L=L)["t"] * 1e3,
               "k1_ms": drv("pallas_sort", variant="k1", k=k, L=L)["t"] * 1e3,
               "library_ms": drv("pallas_sort", variant="torch.sort", k=k, L=L)["t"] * 1e3,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        prev = ""
        if row["variant"] == "wide":  # also on K1's shared-memory kernel, its earlier route
            old = lambda: bitonic._launch("bitonic_network_rows", x, 1)
            check(torch.equal(old(), torch.sort(x, dim=1).values),
                  f"the shared-memory network differs from torch.sort at [{k}, {L}]")
            row["previous_ms"] = min(event_ms(torch, old, 5) for _ in range(2))
            prev = f", on K1's shared-memory kernel {row['previous_ms']:.4f} ms"
        p1_shapes.append(row)
        print(f"P1 at [{k}, {L}] ({row['variant']}): network {row['ms']:.4f} ms{prev}, K1 "
              f"{row['k1_ms']:.4f} ms, torch.sort {row['library_ms']:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del x
    full = drv("ab_wruns", variant="full")["t"] * 1e3
    skip_ms = drv("ab_wruns", variant="skip-w16")["t"] * 1e3
    p2_plain = min(event_ms(torch, lambda: net_plain(xp, skip), 1) for _ in range(2))
    p2_lib = min(event_ms(torch, lambda: torch.sort(xp, dim=1), 5) for _ in range(2))
    p2_k1 = min(event_ms(torch, lambda: bitonic.bitonic_sort_rows(xp), 5)
                for _ in range(2))
    p2_bound, p2_by = sort_bound_ms(xp.numel(), ab_wruns.L)
    saving = drv("ab_wruns", variant="verdict")["pass_skip_saving_pct"]
    print(f"P2 at [{ab_wruns.K}, {ab_wruns.L}], w = {ab_wruns.W}: skip-w16 "
          f"{skip_ms:.4f} ms, full {full:.4f} ms (saving {saving:.2f} %), K1 "
          f"{p2_k1:.4f} ms, torch.sort {p2_lib:.4f} ms, plain {p2_plain:.4f} ms, "
          f"bound {p2_bound:.4f} ms ({p2_by})")
    # P3/P4 at the pallas_gather driver's prototype shape: one class, a 2^16-row
    # table of width 16, 2^20 positions in one group row, every slot valid
    proto = gather_driver.T, gather_driver.W, gather_driver.E
    g_rng = np.random.default_rng(0)
    p_table = torch.from_numpy(g_rng.integers(0, proto[0], proto[:2], dtype=np.int32)).to(dev)
    p_pos = torch.from_numpy(g_rng.integers(0, proto[0], (1, proto[2]), dtype=np.int32)).to(dev)
    p_rows = torch.from_numpy(g_rng.integers(0, gather_driver.ROWS_PAD, (1, proto[2]),
                                             dtype=np.int32)).to(dev)
    gather_proto = time_gathers(
        torch, gather, [(p_table, p_rows, p_pos, proto[1], proto[2], 0)], 1,
        gather_driver.ROWS_PAD, proto[0], proto[1] * proto[2],
        "the pallas_gather driver's prototype shape", reps=20)
    del p_table, p_pos, p_rows
    rates = drv("sort_rate_table", kind="summary")
    print(f"sort-rate table (2^27 elements a shape; launch floor "
          f"{rates['floor_s'] * 1e3:.4f} ms): 2-D {rates['table_2d_ns']}, flat "
          f"{rates['table_flat_ns']}")
    del x2, xp

    phase("16. ESC, giant rows and tuned_executor")
    from binary_spgemm_tpu_torch import SpGEMMExecutor, tuned_executor
    from binary_spgemm_tpu_torch.ops import spgemm as spgemm_mod

    api = {"spgemm_mod": spgemm_mod, "ell": ell, "host": host, "spgemm": spgemm,
           "SpGEMMExecutor": SpGEMMExecutor, "auto_executor": auto_executor,
           "tuned_executor": tuned_executor}
    esc = esc_phase(
        torch, f"on {smi}", api=api, reset_counts=reset_counts, read_counts=read_counts,
        routes=routes, bench=(a, c, ex.n_chunks), rmat18=(a18, c18, times18),
        rmat16=(a16, c16, times16), giant_budget=GIANT_BUDGET,
        expect={"bench_plan": (1, 1 << 24, False), "rmat18_chunks": 26,
                "giant_rows": GIANT_ROWS})
    del a18, c18, a16, c16

    phase("17. the masked, union and fused-OR family, and the one-sort step")
    from binary_spgemm_tpu_torch import masked_spgemm, spgemm_or, spm_or
    from binary_spgemm_tpu_torch.utils.oracle import masked_spgemm_oracle

    api.update(bitonic=bitonic, BCSR=BCSR, masked_spgemm=masked_spgemm,
               spgemm_or=spgemm_or, spm_or=spm_or,
               masked_spgemm_oracle=masked_spgemm_oracle)
    ops = op_family_phase(
        torch, f"on {smi}", api=api, reset_counts=reset_counts, read_counts=read_counts,
        routes=routes, k1_by_variant=k1_by_variant, bench=(a, c),
        bench_run_ms=statistics.median(run_ms))
    op_launches = {label: rec["launches"] for label, rec in ops["products"].items()}

    phase("18. the counting family")
    from binary_spgemm_tpu_torch import masked_spgemm_counts, spgemm_counts
    from binary_spgemm_tpu_torch.ops import counts as counts_mod

    api.update(counts=counts_mod, spgemm_counts=spgemm_counts,
               masked_spgemm_counts=masked_spgemm_counts)
    cnt = counting_phase(
        torch, f"on {smi}", api=api, reset_counts=reset_counts, read_counts=read_counts,
        routes=routes, k1_by_variant=k1_by_variant, bench=a,
        bench_run_ms=statistics.median(run_ms))
    op_launches.update({label: rec["launches"] for label, rec in cnt["products"].items()})

    phase("19. the device API, the one-sort pipeline and the graph ops")
    op_results = ops.pop("results")
    count_results, bench_symmetric = cnt.pop("results"), cnt.pop("bench_symmetric")
    gr = graph_phase(
        torch, f"on {smi}", api=api, reset_counts=reset_counts, read_counts=read_counts,
        routes=routes, k1_by_variant=k1_by_variant, bench=(a, c), main_launches=launches,
        op_results=op_results, count_results=count_results, bench_symmetric=bench_symmetric)
    graph_launches = {label: rec["launches"] for label, rec in gr["products"].items()}

    from binary_spgemm_tpu_torch import write_pattern
    from binary_spgemm_tpu_torch.ops import graph
    from binary_spgemm_tpu_torch.parallel import dist_onesort
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as dist
    from binary_spgemm_tpu_torch.parallel import dryrun
    from binary_spgemm_tpu_torch.parallel.launch import launch

    api.update(dist=dist, dist_onesort=dist_onesort, graph=graph, dryrun=dryrun,
               launch=launch, write_pattern=write_pattern, spgemm_oracle=spgemm_oracle)
    dist_runs = dist_phases(torch, f"on {smi}", api=api, a=a, c=c, op_results=op_results,
                            count_results=count_results, symmetric=bench_symmetric[0],
                            closure=gr.pop("closure_input"))
    del op_results, count_results, bench_symmetric

    phase("22. the native host tier, the CLI's bench and K1's shared-memory kernel")
    from binary_spgemm_tpu_torch import cli, read_pattern
    from binary_spgemm_tpu_torch.formats import bcsr as bcsr_mod
    from binary_spgemm_tpu_torch.io import mmio

    t22 = time.perf_counter()
    path = os.path.join(ROOT, "build", "dist_bench.mtx")  # phase 21 wrote it
    api.update(native=native, mmio=mmio, bcsr_mod=bcsr_mod, read_pattern=read_pattern,
               cli=cli)
    scale, ef, seed_r = RMAT16
    native_rows = native_phase(torch, f"on {smi}", api=api, a=a,
                               a16=BCSR.rmat(scale, ef, seed=seed_r), av=av, path=path)
    bench_cli = bench_cli_phase(
        torch, f"on {smi}", api=api, path=path, reset_counts=reset_counts,
        read_counts=read_counts, k1_by_variant=k1_by_variant, routes=routes,
        e2e_ms=statistics.median(e2e_ms))
    os.remove(path)
    smem = smem_phase(torch, f"on {smi}", bitonic=bitonic, rng=rng)
    print(f"phase 22: {time.perf_counter() - t22:.2f} s on the host clock; {smi}")

    src = "binary_spgemm_tpu_torch/csrc/bitonic.cu"
    # K1's wide kernel: its own path is the op family's A ∪ A·A (run_or), the
    # op that sorts the most with it; every captured stream it sorts is a row
    wide_path = ops["products"]["bench spgemm_or(A, A, A)"]
    wide_rows = [r for r in (*ops["k1"], *cnt["k1"], *gr["k1"]) if r["variant"] == "wide"]
    wide_main = next(r for r in ops["k1"] if r["shape"] == list(OP_SHAPES["or"]))
    check(wide_main["variant"] == "wide" and wide_path["k1_by_variant"]["wide"] > 0,
          f"K1's wide kernel did not run on run_or: {wide_path['k1_by_variant']}")
    kernels = [
        {
            "name": "bitonic_sort_rows", "route": "cuda", "source": src,
            "replaces": "binary_spgemm_tpu/ops/bitonic.py:114",
            "launches": launches["bitonic_sort_rows"],
            "max_abs_err": max(errs["bitonic_sort_rows"], ops["k1_err"], cnt["k1_err"],
                               *(r["max_abs_err"] for r in gr["k1"])),
            "ms": t["k1"],
            "plain_ms": t["k1_plain"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": t["k1_lib"], "shape": shape, "on_main_path": True,
            "variant": k1_variant, "previous_ms": t["k1_smem"],
            "launches_by_variant": k1_variants, "other_shapes": k1_shapes,
            "op_family": ops["k1"], "counting": cnt["k1"], "closure": gr["k1"],
            "launches_by_path": {
                **{label: {"launches": rec["launches"]["bitonic_sort_rows"],
                           "by_variant": rec["k1_by_variant"]}
                   for label, rec in (*ops["products"].items(), *cnt["products"].items())},
                "graph": {label: {"launches": rec["launches"]["bitonic_sort_rows"],
                                  "by_variant": rec["k1_by_variant"]}
                          for label, rec in gr["products"].items()},
                "distributed (per rank)": launches_on(dist_runs, "k1")},
        },
        {
            "name": "bitonic_sort_rows (wide)", "route": "cuda", "source": src,
            "replaces": "binary_spgemm_tpu/ops/bitonic.py:114",
            "launches": wide_path["k1_by_variant"]["wide"],
            "launches_path": "bench spgemm_or(A, A, A) (run_or), phase 17",
            "max_abs_err": max(r["max_abs_err"] for r in wide_rows),
            **{key: wide_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "previous_ms", "shape",
                                               "block")},
            "on_main_path": False, "variant": "wide", "on_path": wide_rows,
            "launches_by_path": {
                **{label: rec["k1_by_variant"]["wide"]
                   for label, rec in (*ops["products"].items(), *cnt["products"].items(),
                                      *gr["products"].items())},
                "distributed (per rank)": launches_on(dist_runs, "k1_wide")},
        },
        {
            "name": "bitonic_sort_rows (smem)", "route": "cuda", "source": src,
            "replaces": "binary_spgemm_tpu/ops/bitonic.py:114",
            "launches": k1_variants["smem"], "max_abs_err": smem["max_abs_err"],
            **{key: smem[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "shape")},
            "on_main_path": False, "variant": "smem",
        },
        {
            "name": "fused_sort_compress", "route": "cuda", "source": src,
            "replaces": "binary_spgemm_tpu/ops/bitonic.py:225",
            "launches": launches["fused_sort_compress"],
            "max_abs_err": errs["fused_sort_compress"], "ms": t["k2"],
            "plain_ms": t["k2_plain"], "bound_ms": bound2, "bound_by": bound2_by,
            "library_ms": None, "shape": shape, "on_main_path": False,
        },
        {
            "name": "grouped_block_matmul", "route": "cuda",
            "source": "binary_spgemm_tpu_torch/csrc/block_matmul.cu",
            "replaces": "binary_spgemm_tpu/ops/pallas_bsr.py:48",
            "launches": launches_b["grouped_block_matmul"],
            "max_abs_err": err_k3, "ms": kt["k3"], "plain_ms": kt["k3_plain"],
            "bound_ms": bound3, "bound_by": bound3_by, "library_ms": None,
            "composition_ms": kt["xla"], "padded_plan_ms": kt["k3_padded"],
            "shape": shape3, "on_main_path": True,
            "variant": k3_variant, "previous_ms": kt["k3_simple"],
            "launches_by_variant": k3_variants, "long_groups": long_groups,
            "output_write_ms": write_ms,
        },
        {
            "name": "class_gather", "route": "cuda",
            "source": "binary_spgemm_tpu_torch/csrc/gather.cu",
            "replaces": "benchmarks/pallas_gather.py:53",
            "launches": launches18["class_gather"],
            "max_abs_err": errs["class_gather"], "ms": gather_rmat["t"]["p3"],
            "plain_ms": gather_rmat["t"]["p3_plain"],
            "bound_ms": gather_rmat["bound3"][0], "bound_by": gather_rmat["bound3"][1],
            "library_ms": gather_rmat["t"]["lib"],
            "shape": dict(gather_rmat["shape"], path="rmat-s18-e8, one group"),
            "on_main_path": True, "variant": "group launch",
            "launches_by_path": {"rmat-s18-e8": launches18["class_gather"],
                                 "random-32k": launches32["class_gather"],
                                 "bench": launches["class_gather"],
                                 "rmat-s16": launches16["class_gather"],
                                 **{k: v["class_gather"] for k, v in op_launches.items()},
                                 "graph": {k: v["class_gather"]
                                           for k, v in graph_launches.items()},
                                 "distributed (per rank)": launches_on(dist_runs, "p3")},
            "on_path": {
                "rmat-s18-e8": gather_row(gather_rmat, "p3", launches18["class_gather"],
                                          "rmat-s18-e8, one group"),
                "random-32k": gather_row(gather_32k, "p3", launches32["class_gather"],
                                         "random 32k, one group")},
            "rmat_s18_bands": bands,
            "off_path": {
                "bench group": gather_row(gather_main, "p3", 0,
                                          "bench group (P3 does not run there)"),
                "rmat-s16 group": gather_row(gather_s16, "p3", 0,
                                             "rmat-s16 group (P3 does not run there)"),
                "prototype": gather_row(gather_proto, "p3", 0,
                                        "pallas_gather driver's prototype shape")},
        },
        {
            "name": "class_gather_keys", "route": "cuda",
            "source": "binary_spgemm_tpu_torch/csrc/gather.cu",
            "replaces": "benchmarks/pallas_gather.py:75",
            "launches": launches["class_gather_keys"],
            "max_abs_err": errs["class_gather_keys"], "ms": gather_main["t"]["p4"],
            "plain_ms": gather_main["t"]["p4_plain"],
            "bound_ms": gather_main["bound4"][0], "bound_by": gather_main["bound4"][1],
            "library_ms": gather_main["t"]["lib"],
            "shape": dict(gather_main["shape"], path="bench config, one group"),
            "on_main_path": True, "variant": "group launch",
            "launches_by_path": {"bench": launches["class_gather_keys"],
                                 "rmat-s16": launches16["class_gather_keys"],
                                 "rmat-s18-e8": launches18["class_gather_keys"],
                                 "random-32k": launches32["class_gather_keys"],
                                 **{k: v["class_gather_keys"] for k, v in op_launches.items()},
                                 "graph": {k: v["class_gather_keys"]
                                           for k, v in graph_launches.items()},
                                 "distributed (per rank)": launches_on(dist_runs, "p4")},
            "on_path": {
                "bench": gather_row(gather_main, "p4", launches["class_gather_keys"],
                                    "bench config, one group"),
                "rmat-s16": gather_row(gather_s16, "p4", launches16["class_gather_keys"],
                                       "rmat-s16, one group")},
            "off_path": {
                "rmat-s18-e8 group": gather_row(
                    gather_rmat, "p4", 0, "rmat-s18-e8 group (P4 does not run there)"),
                "random-32k group": gather_row(
                    gather_32k, "p4", 0, "random 32k group (P4 does not run there)"),
                "prototype": gather_row(gather_proto, "p4", 0,
                                        "pallas_gather driver's prototype shape")},
        },
        {
            "name": "bitonic_network_rows (P1, min_kk=2)", "route": "cuda",
            "source": src, "replaces": "benchmarks/pallas_sort.py:61",
            "launches": sum(v["bitonic_network_rows"] for v in serving.values()),
            "launches_by_path": {k: v["bitonic_network_rows"] for k, v in serving.items()},
            "driver_launches": {"pallas_sort": drivers["pallas_sort"]["launches"][
                "bitonic_network_rows"]},
            "max_abs_err": err_net, "ms": p1_shapes[-1]["ms"],
            "plain_ms": p1_shapes[-1]["plain_ms"], "bound_ms": p1_shapes[-1]["bound_ms"],
            "bound_by": p1_shapes[-1]["bound_by"],
            "library_ms": p1_shapes[-1]["library_ms"], "shape": p1_shapes[-1]["shape"],
            "variant": p1_shapes[-1]["variant"], "k1_ms": p1_shapes[-1]["k1_ms"],
            "on_main_path": False, "other_shapes": p1_shapes[:-1],
        },
        {
            "name": "bitonic_network_rows (P2, min_kk=32)", "route": "cuda",
            "source": src, "replaces": "benchmarks/ab_wruns.py:38",
            "launches": sum(v["bitonic_network_rows"] for v in serving.values()),
            "launches_by_path": {k: v["bitonic_network_rows"] for k, v in serving.items()},
            "driver_launches": {"ab_wruns": drivers["ab_wruns"]["launches"][
                "bitonic_network_rows"]},
            "max_abs_err": err_net, "ms": skip_ms, "plain_ms": p2_plain,
            "bound_ms": p2_bound, "bound_by": p2_by, "library_ms": p2_lib,
            "shape": [ab_wruns.K, ab_wruns.L], "variant": bitonic.k1_variant(ab_wruns.L),
            "full_ms": full, "k1_ms": p2_k1, "saving_pct": saving,
            "on_main_path": False,
        },
    ]
    phase("23. kernels")
    paths = {"native": native_rows, "bench_cli": bench_cli, "distributed": {run: {label: row["s"] for label, row in rows.items()}
                             for run, rows in dist_runs.items()},"rmat-s16": times16, "rmat-s18-e8": times18, "random-32k": times32,
             "esc": esc, "op_family": {k: ops[k] for k in ("times", "cummax_ms")},
             "counting": cnt["times"],
             "graph": {k: gr[k] for k in ("k_hop_s", "closure", "onesort_stream", "cli_s")}}
    print(f"paths: {json.dumps(paths)}")
    print(f"drivers (s): {json.dumps({k: v['s'] for k, v in drivers.items()})}")
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
