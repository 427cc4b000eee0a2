"""Command-line interface of the port: benchmark, data generation, one-shot
products, graph ops and the distributed check.

    python -m binary_spgemm_tpu_torch.cli bench a.mtx --times 5 --json
    python -m binary_spgemm_tpu_torch.cli bench a.mtx --scaling-report --devices 2
    python -m binary_spgemm_tpu_torch.cli gen a.mtx -n 4096 -d 4 --seed 1
    python -m binary_spgemm_tpu_torch.cli multiply a.mtx --out c.mtx
    python -m binary_spgemm_tpu_torch.cli graph a.mtx closure --resident --out r.mtx
    python -m binary_spgemm_tpu_torch.cli validate a.mtx --devices 4 --oracle

Counterpart of ``binary_spgemm_tpu/cli.py``, every command with the same
flags, outputs and exit codes, and two changes of name: ``--device
{cuda,cpu}`` picks the torch device (``cuda`` unless told otherwise), and
``graph --resident`` is the JAX CLI's ``graph --device`` (keep the iterated
products' matrices on the device).  ``bench`` prints the reference's CSV
line (and ``--json`` the JAX CLI's record), ``bench --scaling-report`` the
report of :mod:`.parallel.scaling`.  ``validate --devices N`` and ``bench
--devices N`` start N ranks on this machine (:mod:`.parallel.launch`: NCCL
with a card a rank, else gloo); under ``torchrun`` they start the group by
the same rule, over the ranks on its machine (``LOCAL_WORLD_SIZE``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .formats.bcsr import BCSR
from .io.mmio import read_pattern, write_integer, write_pattern
from .ops.spgemm import DEFAULT_CHUNK_FLOPS, spgemm


def _load(path: str, transpose: bool) -> BCSR:
    return read_pattern(path, transpose=transpose)


def _single_device_spgemm(a, args, b=None):
    b = a if b is None else b
    if args.engine == "ell":
        from .ops.ell import ell_spgemm

        return ell_spgemm(a, b, device=args.device)
    if args.engine == "esc":
        return spgemm(a, b, chunk_flops=args.chunk_flops or DEFAULT_CHUNK_FLOPS,
                      device=args.device)
    return spgemm(a, b, chunk_flops=args.chunk_flops, device=args.device)


def _torchrun_mesh(args):
    """Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set): start the group
    over :func:`.parallel.launch.torchrun_backend`'s backend (NCCL only where
    each of this machine's ranks has a card of its own) and return this
    rank's mesh over it; ``None`` outside ``torchrun``."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    from .ops.spgemm import resolve_device
    from .parallel import multihost
    from .parallel.launch import torchrun_backend

    resolve_device(args.device)  # --device cuda without a card raises
    multihost.initialize(backend=torchrun_backend(args.device))
    return multihost.global_row_mesh(args.device)


def _group_size_differs(args, mesh) -> bool:
    if args.devices is not None and args.devices != mesh.size:
        print(f"--devices {args.devices} != the group's {mesh.size} ranks",
              file=sys.stderr)
        return True
    return False


def _sync(device) -> None:
    """The bench's barrier: the card's work done (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _bench_rank(mesh, a, balance: str, b_layout: str, engine: str, times: int):
    """``times`` repeats of C = A·A over the ranks, after a warm-up: each
    timed between two barriers, so rank 0's walls are the slowest rank's.
    Returns ``(output nnz, walls)``."""
    from .parallel.dist_spgemm import dist_spgemm
    from .parallel.multihost import barrier

    def run():
        c = dist_spgemm(a, a, mesh, balance=balance, b_layout=b_layout, engine=engine)
        _sync(mesh.device)
        return c

    nnz = run().nnz
    walls = []
    for _ in range(times):
        barrier()
        t0 = time.perf_counter()
        run()
        barrier()
        walls.append(time.perf_counter() - t0)
    return nnz, walls


def cmd_bench(args) -> int:
    """C = A·A timed over ``--times`` repeats (≡ ``SpGEMM_mpi_omp path tBlock
    threads times``): the reference's CSV line
    ``tasks,threads,total_cpus,blocksize,path,n,input_nnz,output_nnz,mean,median,fastest``
    and, with ``--json``, the JAX CLI's record.  ``--scaling-report`` prints
    :mod:`.parallel.scaling`'s report instead; ``--sweep`` one CSV line per
    ``--chunk-flops`` value."""
    if args.sweep:
        for value in args.sweep.split(","):
            sub_args = argparse.Namespace(**vars(args))
            sub_args.sweep = None
            sub_args.chunk_flops = int(value)
            rc = cmd_bench(sub_args)
            if rc:
                return rc
        return 0
    import torch.distributed as dist

    from .ops.spgemm import resolve_device, spgemm_flops
    from .utils.timers import BenchStats, bench_fn

    device = resolve_device(args.device)
    a = _load(args.path, args.transpose)
    if a.n_rows != a.n_cols:
        print("bench computes C = A*A; matrix must be square", file=sys.stderr)
        return 2
    mesh = _torchrun_mesh(args)
    if mesh is not None and _group_size_differs(args, mesh):
        return 2
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    if args.scaling_report:
        from .parallel.scaling import format_scaling_report, scaling_report

        counts = None
        if args.devices:
            counts = [d for d in (1, 2, 4, 8, 16, 32) if d < args.devices]
            counts.append(args.devices)
        eng = args.engine if args.engine in ("esc", "ell") else "esc"
        rep = scaling_report(a, device_counts=counts, balance=args.balance,
                             times=args.times, engine=eng, b_layout=args.b_layout,
                             device=device)
        if rank0:
            print(json.dumps(rep) if args.json else format_scaling_report(rep))
        return 0

    n_devices = mesh.size if mesh is not None else (args.devices or 1)
    if mesh is not None or n_devices > 1:
        bench = (args.balance, args.b_layout, args.engine, args.times)
        if mesh is not None:
            out_nnz, walls = _bench_rank(mesh, a, *bench)
        else:
            from .parallel.launch import launch

            out_nnz, walls = launch(_bench_rank, n_devices, a, *bench, device=device,
                                    timeout=3600.0)[0]
        stats = BenchStats(walls)
    else:
        if args.tune:
            # the model's plausibly best batched bin counts, measured once;
            # the fastest is benched (ops/ell.py::tuned_executor)
            from .ops.ell import tuned_executor

            ex = tuned_executor(a, a, device=device)
            if getattr(ex, "tune_report", None):
                print("tuned: k=%d  %s" % (
                    ex.n_chunks, " ".join(f"{k}:{t:.4f}s" for t, k in ex.tune_report)),
                    file=sys.stderr)

            def run():
                return ex.assemble(ex.run())
        else:
            def run():
                return _single_device_spgemm(a, args)

        out_nnz = run().nnz  # warm-up: builds the kernels and the plan
        _sync(device)
        stats = bench_fn(run, repeats=args.times, barrier=lambda: _sync(device))
    if not rank0:
        return 0
    blocksize = (args.chunk_flops or 0) if n_devices == 1 else a.n_rows // n_devices
    print(f"{n_devices},1,{n_devices},{blocksize},{args.path},{a.n_rows},"
          f"{a.nnz},{out_nnz},{stats.mean:.6f},{stats.median:.6f},{stats.fastest:.6f}")
    if args.json:
        flops = spgemm_flops(a, a)
        print(json.dumps({
            "devices": n_devices,
            "platform": device.type,
            "path": args.path,
            "n": a.n_rows,
            "input_nnz": a.nnz,
            "output_nnz": out_nnz,
            "flops": flops,
            "mean_s": stats.mean,
            "median_s": stats.median,
            "fastest_s": stats.fastest,
            "output_nnz_per_s": out_nnz / stats.fastest,
            "flops_per_s": flops / stats.fastest,
        }))
    return 0


def _validate_rank(mesh, a, balance: str, b_layout: str):
    from .parallel.dist_spgemm import dist_spgemm

    return dist_spgemm(a, a, mesh, balance=balance, b_layout=b_layout)


def cmd_validate(args) -> int:
    """C = A·A over the ranks against the one-device product (and, with
    ``--oracle``, the latter against scipy): the reference's ``make test``
    (SpGEMM_mpi_omp_validity)."""
    from .ops.spgemm import resolve_device
    from .parallel.launch import launch
    from .utils.oracle import spgemm_oracle

    a = _load(args.path, args.transpose)
    mesh = _torchrun_mesh(args)
    if mesh is not None:
        if _group_size_differs(args, mesh):
            return 2
        c_pars = [_validate_rank(mesh, a, args.balance, args.b_layout)]
    else:
        import torch

        n = args.devices
        if n is None:
            n = torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 1
        if n == 1:  # this process alone
            from .parallel.mesh import make_row_mesh

            c_pars = [_validate_rank(make_row_mesh(1, device=args.device), a,
                                     args.balance, args.b_layout)]
        else:
            c_pars = launch(_validate_rank, n, a, args.balance, args.b_layout,
                            device=args.device, timeout=3600.0)
    c_ser = _single_device_spgemm(a, args)
    ok = all(c.equals(c_ser) for c in c_pars)
    oracle_ok = True
    if args.oracle:
        oracle_ok = c_ser.equals(spgemm_oracle(a, a))
    if ok and oracle_ok:
        # ≡ final/SpGEMM_mpi_omp_validity.c:340
        print("Results of serial and multicore are the same!")
        return 0
    if not ok:
        print("MISMATCH between serial and multi-device results", file=sys.stderr)
        bad = next(c for c in c_pars if not c.equals(c_ser))
        print(bad.diff(c_ser), file=sys.stderr)
    if not oracle_ok:
        print("MISMATCH vs scipy oracle", file=sys.stderr)
        print(c_ser.diff(spgemm_oracle(a, a)), file=sys.stderr)
    return 1


def cmd_gen(args) -> int:
    if args.rmat:
        scale = args.n.bit_length() - 1
        if (1 << scale) != args.n:
            raise SystemExit("--rmat requires n to be a power of two")
        mat = BCSR.rmat(scale, args.d, seed=args.seed)
        comment = f"rmat pattern n={args.n} edge_factor={args.d} seed={args.seed}"
    else:
        mat = BCSR.random(args.n, args.n, args.d, seed=args.seed)
        comment = f"random pattern n={args.n} d={args.d} seed={args.seed}"
    write_pattern(args.out, mat, comment=comment)
    print(f"wrote {args.out}: n={args.n} nnz={mat.nnz}")
    return 0


def cmd_multiply(args) -> int:
    """One op — C = A·B, F.*(A·B), D OR (A·B) or D OR (F.*(A·B)) — written
    as a pattern ``.mtx`` with ``--out``; ``--counts`` gives each entry's
    multiplicity and writes an integer ``.mtx``."""
    a = _load(args.path, args.transpose)
    b = _load(args.b, args.transpose) if args.b else a
    kw = {"chunk_flops": args.chunk_flops, "device": args.device}
    if args.engine == "esc" and kw["chunk_flops"] is None:
        kw["chunk_flops"] = DEFAULT_CHUNK_FLOPS
    mask = _load(args.mask, args.transpose) if args.mask else None
    source = f"{args.path}" + (f" * {args.b}" if args.b else " squared")
    if args.counts:
        if args.fuse_or:
            print("--counts cannot combine with --fuse-or", file=sys.stderr)
            return 2
        from .ops.counts import masked_spgemm_counts, spgemm_counts

        # --engine esc is a forced chunk_flops above; "ell" goes through so
        # the counts entry points force it or raise
        ckw = dict(kw, engine="ell") if args.engine == "ell" else kw
        if mask is not None:
            c, counts = masked_spgemm_counts(mask, a, b, **ckw)
        else:
            c, counts = spgemm_counts(a, b, **ckw)
        if args.out:
            write_integer(args.out, c, counts, comment=f"integer product from {source}")
        total = int(counts.sum()) if counts.size else 0
        print(f"C: shape={c.shape} nnz={c.nnz} sum(counts)={total}"
              + (f" -> {args.out}" if args.out else ""))
        return 0
    if args.fuse_or:
        from .ops.fused import spgemm_or

        d = _load(args.fuse_or, args.transpose)
        c = spgemm_or(d, a, b, mask=mask, **kw)
    elif mask is not None:
        from .ops.masked import masked_spgemm

        c = masked_spgemm(mask, a, b, **kw)
    else:
        c = _single_device_spgemm(a, args, b)
    if args.out:
        write_pattern(args.out, c, comment=f"C from {source}")
    print(f"C: shape={c.shape} nnz={c.nnz}" + (f" -> {args.out}" if args.out else ""))
    return 0


def _write_csv(args, label: str, values: str) -> None:
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(values + "\n")
        print(f"{label} -> {args.out}")
    else:
        print(values)


def cmd_graph(args) -> int:
    """Graph ops over the SpGEMM core: closure, k-hop, triangles, BFS,
    k-truss and clustering coefficients."""
    from .ops import graph

    if args.op in ("triangles", "bfs", "ktruss", "clustering") and args.resident:
        print(f"{args.op} has no resident form", file=sys.stderr)
        return 2
    a = _load(args.path, args.transpose)
    kw = {"chunk_flops": args.chunk_flops, "device": args.device}
    if args.op == "bfs":
        if not args.sources:
            print("bfs needs --sources", file=sys.stderr)
            return 2
        try:
            sources = [int(s) for s in args.sources.split(",")]
        except ValueError:
            print(f"--sources must be comma-separated integers, got {args.sources!r}",
                  file=sys.stderr)
            return 2
        lv = graph.bfs_levels(a, sources, max_hops=args.max_iters, **kw)
        print(f"bfs: n={a.n_rows} reachable={int((lv >= 0).sum())} "
              f"max_level={int(lv.max())}")
        _write_csv(args, "levels", ",".join(str(int(x)) for x in lv))
        return 0
    if args.op == "clustering":
        cc = graph.clustering_coefficients(a, **kw)
        print(f"clustering: n={a.n_rows} mean={float(cc.mean()):.6g} "
              f"max={float(cc.max()):.6g}")
        _write_csv(args, "coefficients", ",".join(f"{x:.6g}" for x in cc))
        return 0
    if args.op == "closure":
        c = graph.transitive_closure(a, max_iters=args.max_iters, resident=args.resident,
                                     one_sort=not args.two_sort, **kw)
    elif args.op == "khop":
        c = graph.k_hop(a, args.k, resident=args.resident, one_sort=not args.two_sort,
                        **kw)
    elif args.op == "ktruss":
        if args.k < 3:
            print("ktruss needs --k >= 3", file=sys.stderr)
            return 2
        c = graph.k_truss(a, args.k, **kw)
    elif args.count:
        print(f"triangles: n={a.n_rows} count={graph.triangle_count(a, **kw)}")
        return 0
    else:
        c = graph.triangle_structure(a, **kw)
    if args.out:
        write_pattern(args.out, c, comment=f"{args.op} of {args.path}")
    print(f"{args.op}: shape={c.shape} nnz={c.nnz}"
          + (f" -> {args.out}" if args.out else ""))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="binary_spgemm_tpu_torch",
        description="boolean SpGEMM on a CUDA card: benchmark, data generation, "
        "products, graph ops and the distributed check",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    io_common = argparse.ArgumentParser(add_help=False)
    io_common.add_argument("path", help="Matrix-Market pattern file")
    io_common.add_argument(
        "--no-transpose", dest="transpose", action="store_false",
        help="read the file as-is instead of the reference's transpose semantics",
    )
    io_common.add_argument(
        "--chunk-flops", type=int, default=None,
        help="max Gustavson flops per ESC row chunk; setting it forces the ESC "
        "engine (default: auto engine, sliced-ELL when it fits)",
    )
    io_common.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="torch device (cpu runs every kernel's plain torch version)",
    )
    engine_common = argparse.ArgumentParser(add_help=False)
    engine_common.add_argument(
        "--engine", choices=["auto", "esc", "ell"], default="auto",
        help="SpGEMM engine (auto = sliced-ELL when its expansion fits)",
    )

    common = argparse.ArgumentParser(add_help=False, parents=[io_common, engine_common])
    common.add_argument(
        "--devices", type=int, default=None,
        help="ranks (≈ MPI tasks; default: one a card, or 1 on the CPU); "
        "started here over NCCL with a card a rank, else gloo",
    )
    common.add_argument(
        "--balance", choices=["flops", "rows"], default="flops",
        help="row partition strategy (rows = reference parity)",
    )
    common.add_argument(
        "--b-layout", choices=["replicated", "sharded", "ring"], default="replicated",
        help="B operand layout over the ranks (replicated = reference parity; "
        "sharded = all-gathered in the step; ring = rotated, O(nnz/S) memory)",
    )
    bn = sub.add_parser("bench", parents=[common], help="time C = A*A")
    bn.add_argument("--times", type=int, default=5, help="repeat count")
    bn.add_argument("--json", action="store_true", help="also print a JSON record")
    bn.add_argument(
        "--tune", action="store_true",
        help="measure the model's plausible-best batched bin counts once and "
        "bench the fastest (staged; one plan per candidate)",
    )
    bn.add_argument(
        "--scaling-report", action="store_true",
        help="measure the row-partitioned step at 1..N ranks (N = --devices, or "
        "one a card), separating per-shard compute from collective time; prints "
        "the >=80%% efficiency report",
    )
    bn.add_argument(
        "--sweep", default=None,
        help="comma-separated chunk-flops values to sweep (one CSV line each; "
        "the reference's tBlock blocksize sweep)",
    )
    bn.set_defaults(fn=cmd_bench)

    v = sub.add_parser("validate", parents=[common],
                       help="serial vs multi-device bit-exact check")
    v.add_argument("--oracle", action="store_true", help="also compare against scipy")
    v.set_defaults(fn=cmd_validate)

    m = sub.add_parser(
        "multiply", parents=[io_common, engine_common],
        help="compute C = A*B (masked / fused-OR variants) and write it",
    )
    m.add_argument("b", nargs="?", default=None, help="B operand (default: A)")
    m.add_argument("--mask", default=None, help="mask F: C = F .* (A*B)")
    m.add_argument("--fuse-or", default=None, help="D operand: C = D OR (F.*?(A*B))")
    m.add_argument("--out", default=None, help="write C as a pattern .mtx")
    m.add_argument(
        "--counts", action="store_true",
        help="counting multiply: per-entry multiplicities (the integer product "
        "of 0/1 matrices); --out writes coordinate integer .mtx",
    )
    m.set_defaults(fn=cmd_multiply)

    gr = sub.add_parser("graph", parents=[io_common],
                        help="closure / k-hop / triangles / bfs / k-truss / clustering")
    gr.add_argument("op", choices=["closure", "khop", "triangles", "bfs", "ktruss",
                                   "clustering"])
    gr.add_argument("--k", type=int, default=2, help="k for khop/ktruss")
    gr.add_argument("--max-iters", type=int, default=None)
    gr.add_argument("--sources", default=None,
                    help="comma-separated source node ids (bfs; levels print as CSV)")
    gr.add_argument(
        "--count", action="store_true",
        help="triangles: print the triangle COUNT (device counting kernel, needs a "
        "symmetric hollow adjacency) instead of the edge structure",
    )
    gr.add_argument(
        "--resident", action="store_true",
        help="closure/khop: keep the matrices on the device between products "
        "(two scalar reads a round)",
    )
    gr.add_argument(
        "--two-sort", action="store_true",
        help="with --resident: compacted rounds instead of the default one-sort "
        "streams with holes (ops/onesort.py)",
    )
    gr.add_argument("--out", default=None, help="write the result .mtx")
    gr.set_defaults(fn=cmd_graph)

    g = sub.add_parser("gen", help="generate a random pattern .mtx")
    g.add_argument("out")
    g.add_argument("-n", type=int, required=True, help="matrix dimension")
    g.add_argument("-d", type=float, required=True, help="nnz per row")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument(
        "--rmat", action="store_true",
        help="power-law R-MAT graph instead of uniform Bernoulli (n must be a "
        "power of two)",
    )
    g.set_defaults(fn=cmd_gen)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
