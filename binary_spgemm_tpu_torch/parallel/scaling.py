"""Scaling report: the row-partitioned step at growing rank counts.

Counterpart of ``binary_spgemm_tpu/parallel/scaling.py``, with its report
schema.  For each rank count n the step of one (engine, B layout) pair runs
on the first n ranks of one group; where the step's collectives can be
taken out, the same per-shard compute runs without them, and the difference
is the collective time.  Strong scaling on a fixed matrix: efficiency(n) =
T(1) / (n · T(n)), and a normalised efficiency that takes out the launch
floor and the plan's padded work (see :func:`scaling_report`).

The counts run in one group of ``max(device_counts)`` ranks, started by
:func:`.launch.launch` or the caller's (``torchrun``, or a launched rank):
count n runs on a subgroup (``dist.new_group``) of ranks ``0 .. n-1`` while
the others wait at a barrier of the whole group.  The first n ranks, because
the ring's point-to-point ops (:class:`.comm.RingShift`) name their peers by
global rank, which equals the subgroup rank only there.

A rank is a card.  NCCL takes one rank a card; counts past the card count
run ranks that share a card over gloo, and measure card sharing, not
scaling: the report then says so (``cards``, ``artifact_note``) and
``meets_target`` is judged over the counts up to the card count (up to the
cores on the CPU).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..formats.bcsr import BCSR
from ..ops.spgemm import expand_pairs, pad_bucket, resolve_device, row_flops, sort_compress
from . import comm
from .dist_spgemm import (
    _ell_kw,
    _esc_a,
    _esc_b,
    _mine,
    _shard_ell_operands,
    _shard_ring_ell_operands,
    _stage_ell,
    dist_spgemm,
    dist_spgemm_ell,
    dist_spgemm_ring,
    dist_spgemm_ring_ell,
    dist_spgemm_sharded,
    dist_spgemm_sharded_b,
    ring_step_pad,
    shard_b_operands,
    shard_operands,
)
from .mesh import RowMesh, make_row_mesh, partition_rows

__all__ = ["EFFICIENCY_TARGET", "format_scaling_report", "scaling_report"]

EFFICIENCY_TARGET = 0.8  # >= 80 % from one rank to n >= 2 (BASELINE.json)


def _compute_only_sharded(a_ptr, a_idx, a_nnz: int, b_ptr, b_idx, *, n_cols: int,
                          flops_pad: int):
    """The ESC step minus its collectives: this rank's expansion and
    compression, without the pointer fix's gather (the analogue of timing
    between the reference's compute and its MPI_Reduce/Gatherv block,
    final/SpGEMM_mpi_omp.c:174-204)."""
    row, col = expand_pairs(a_ptr, a_idx, a_nnz, b_ptr, b_idx, n_cols=n_cols,
                            flops_pad=flops_pad, check_total=False)
    return sort_compress(row, col, a_ptr.shape[0] - 1, n_cols)


def _build_step(a: BCSR, b: BCSR, engine: str, b_layout: str, mesh: RowMesh,
                balance: str, flops_pad1: int, rf: np.ndarray):
    """Stage this rank's operands and return ``(step, compute | None,
    meta)``.  ``compute`` (the step minus its collectives) exists where that
    split is separable: the ring layouts interleave the transfers with the
    expansion by design, so they have none, and neither has ELL over
    replicated tables."""
    nd, m = mesh.size, b.n_cols
    if engine == "esc":
        # the JAX package's pad (the product's bucket over the shards),
        # raised to the largest shard's bucket where a shard holds more, so
        # the step never truncates its expansion
        bounds = partition_rows(rf, nd, balance=balance)
        need = max(int(rf[r0:r1].sum()) for r0, r1 in zip(bounds, bounds[1:]))
        flops_pad = max(flops_pad1 // nd, 1)
        if need > flops_pad:
            flops_pad = pad_bucket(need)
        ops = shard_operands(a, b, nd, balance=balance, flops_pad=flops_pad)
        meta = {"rows_pad": ops.rows_pad, "flops_pad": ops.flops_pad,
                "padded_slots_per_shard": ops.flops_pad}
        a_args = _esc_a(ops, mesh)
        kw = dict(mesh=mesh, n_cols=m, flops_pad=ops.flops_pad)
        if b_layout == "ring":
            b_ptr_sh, b_idx_sh, m_per = shard_b_operands(b, nd)
            b_sh = (_mine(b_ptr_sh, mesh), _mine(b_idx_sh, mesh))
            step_pad = ring_step_pad(a, b, ops.bounds, m_per, nd)
            meta.update(step_pad=step_pad, padded_slots_per_shard=step_pad * nd)
            return (lambda: dist_spgemm_ring(*a_args, *b_sh, mesh=mesh, n_cols=m,
                                             m_per=m_per, step_pad=step_pad),
                    None, meta)
        b_args = _esc_b(ops, mesh)
        # compute-only is the per-shard kernel on the whole B: against the
        # sharded layout, the difference is the in-step gather of B
        compute = lambda: _compute_only_sharded(  # noqa: E731
            *a_args, *b_args, n_cols=m, flops_pad=ops.flops_pad)
        if b_layout == "replicated":
            return lambda: dist_spgemm_sharded(*a_args, *b_args, **kw), compute, meta
        b_ptr_sh, b_idx_sh, _ = shard_b_operands(b, nd)
        b_sh = (_mine(b_ptr_sh, mesh), _mine(b_idx_sh, mesh))
        return lambda: dist_spgemm_sharded_b(*a_args, *b_sh, **kw), compute, meta

    bounds = partition_rows(rf, nd, balance=balance)
    if b_layout == "ring":
        tbl, er, ep, widths, ent_pads, rows_pad, step_pad = _shard_ring_ell_operands(
            a, b, nd, bounds)
        staged = [[_mine(x, mesh) for x in xs] for xs in (tbl, er, ep)]
        return (lambda: dist_spgemm_ring_ell(
                    *staged, mesh=mesh, rows_pad=rows_pad, n_cols=m, widths=widths,
                    ent_pads=ent_pads, step_pad=step_pad),
                None,
                # each rank expands nd rotated slices of step_pad slots
                {"rows_pad": rows_pad, "step_pad": step_pad,
                 "padded_slots_per_shard": step_pad * nd})
    sharded = b_layout == "sharded"
    plan = _shard_ell_operands(a, b, nd, bounds, rf, b_tables=b_layout,
                               allow_batched=True)
    staged = _stage_ell(plan, mesh, sharded)
    step = lambda: dist_spgemm_ell(  # noqa: E731
        *staged, mesh=mesh, n_cols=m, gather_tables=sharded, **_ell_kw(plan))
    compute = None
    if sharded:
        # compute-only is the same expansion and sorts on replicated tables:
        # the difference is the in-step gather of the class tables
        plan_r = _shard_ell_operands(a, b, nd, bounds, rf, allow_batched=True)
        staged_r = _stage_ell(plan_r, mesh)
        compute = lambda: dist_spgemm_ell(  # noqa: E731
            *staged_r, mesh=mesh, n_cols=m, **_ell_kw(plan_r))
    n_sub = plan[7].shape[1] - 1
    return step, compute, {"rows_pad": plan[5], "sort_pad": plan[6],
                           "batched": plan[8], "sub_chunks": n_sub,
                           "padded_slots_per_shard": n_sub * plan[6]}


def _sync(mesh: RowMesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def _timed(fn, mesh: RowMesh, times: int) -> float:
    """The step time of ``fn`` on the ranks of ``mesh``: after a warm-up
    call, each repeat is a barrier, the call, a synchronize and a gather of
    every rank's wall; a repeat takes its slowest rank, the result the
    fastest repeat."""
    fn()
    _sync(mesh)
    best = float("inf")
    for _ in range(times):
        _barrier(mesh.group)
        t0 = time.perf_counter()
        fn()
        _sync(mesh)
        wall = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
        best = min(best, float(comm.all_gather_host(wall, mesh).max()))
    return best


def _report(world: RowMesh, a: BCSR, b: BCSR, *, engine: str, b_layout: str,
            counts: list[int], balance: str, times: int, verify: bool,
            cards: int | None) -> dict:
    """Every rank of ``world`` runs this; rank 0's report comes back on every
    rank."""
    from ..utils.oracle import spgemm_oracle
    from ..utils.trace import measure_dispatch_floor

    # every rank makes every subgroup, in one order (dist.new_group's rule)
    groups = {n: world.group if n == world.size else dist.new_group(list(range(n)))
              for n in sorted(set(counts))}
    rf = row_flops(a, b)
    flops_pad1 = pad_bucket(max(int(rf.sum()), 1))
    floor_s = measure_dispatch_floor(device=world.device)
    rows = []
    t1 = w1 = None
    for nd in counts:
        if world.rank < nd:
            mesh = RowMesh(groups[nd], world.rank, nd, world.device)
            step, compute, meta = _build_step(a, b, engine, b_layout, mesh, balance,
                                              flops_pad1, rf)
            step_s = _timed(step, mesh, times)
            compute_s = _timed(compute, mesh, times) if compute is not None else None
            del step, compute  # release this count's staged operands
            w_total = nd * meta.get("padded_slots_per_shard", 0)
            if t1 is None:
                t1, w1 = step_s, w_total
            t1_adj = max(t1 - floor_s, 1e-9)
            tn_adj = max(step_s - floor_s, 1e-9)
            work_ratio = (w_total / w1) if w1 else 1.0
            rows.append({
                "devices": nd,
                "step_s": step_s,
                "compute_s": compute_s,
                "collective_s": (max(step_s - compute_s, 0.0)
                                 if compute_s is not None else None),
                "speedup": t1 / step_s,
                "efficiency": t1 / (nd * step_s),
                "padded_work_total": w_total,
                "work_vs_1dev": round(work_ratio, 4),
                # floor-subtracted, padded-work-normalised: the column
                # meets_target reads
                "efficiency_norm": t1_adj * work_ratio / (nd * tn_adj),
                **meta,
            })
        _barrier(world.group)
    bit_exact = None
    n_max = max(counts)
    if verify and world.rank < n_max:
        got = dist_spgemm(a, b, RowMesh(groups[n_max], world.rank, n_max, world.device),
                          balance=balance, b_layout=b_layout, engine=engine)
        if world.rank == 0:
            bit_exact = bool(got.equals(spgemm_oracle(a, b)))
    _barrier(world.group)

    rep = {
        "kind": "scaling_report",
        "engine": engine,
        "b_layout": b_layout,
        "n": a.n_rows,
        "input_nnz": a.nnz,
        "flops": int(rf.sum()),
        "balance": balance,
        "platform": world.device.type,
        "host_cores": os.cpu_count() or 1,
        "floor_s": round(floor_s, 6),
        "bit_exact": bit_exact,
        "efficiency_target": EFFICIENCY_TARGET,
        **_gate(rows, n_max, world.device.type, cards, os.cpu_count() or 1),
        "rows": rows,
    }
    if world.group is not None:
        box = [rep]
        dist.broadcast_object_list(box, src=0, group=world.group)
        rep = box[0]
    return rep


def _gate(rows: list[dict], n_max: int, platform: str, cards: int | None,
          n_cores: int) -> dict:
    """``meets_target`` over the counts that measure scaling (up to the card
    count on the card, up to the cores on the CPU), its scope, and past
    those counts ``artifact_note`` (and ``cards`` on the card)."""
    limit = cards if platform == "cuda" else n_cores
    multi = [r for r in rows if r["devices"] > 1]
    gated = [r for r in multi if r["devices"] <= limit]
    scope = (f"devices<={cards} (cards)" if platform == "cuda"
             else f"devices<={n_cores} (physical cpu cores)")
    out = {
        "meets_target": bool(gated and all(r["efficiency_norm"] >= EFFICIENCY_TARGET
                                           for r in gated)),
        "meets_target_scope": (scope if any(r["devices"] > limit for r in multi)
                               else "all mesh sizes"),
    }
    if n_max > limit:
        if platform == "cuda":
            out["cards"] = cards
            out["artifact_note"] = (
                f"{cards} card(s): past {cards} ranks the ranks share a card over "
                "gloo, so those sizes measure card sharing, not scaling")
        else:
            out["artifact_note"] = (
                f"CPU ranks: past {n_cores} ranks the processes oversubscribe the "
                f"{n_cores} cores, so those sizes measure oversubscription, not "
                "scaling")
    return out


def _report_rank(mesh: RowMesh, a: BCSR, b: BCSR, kw: dict) -> dict:
    return _report(mesh, a, b, **kw)


def scaling_report(
    a: BCSR,
    b: BCSR | None = None,
    *,
    engine: str = "esc",
    b_layout: str = "replicated",
    device_counts: list[int] | None = None,
    balance: str = "flops",
    times: int = 3,
    verify: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Measure the row-partitioned step at growing rank counts.

    Per count: the step's time (compute, collectives and the in-step
    pointer fix; not the host assembly), the compute-only time where the
    split is separable, their difference, the speedup over one rank and the
    strong-scaling efficiency, raw and normalised.  The raw ``T(1)/(n·T(n))``
    mixes parallel speedup with two other things: the plan's padded work
    shrinking with a shard's flop share, and the launch floor.  The
    normalised column takes them out:

        eff_norm(n) = (T(1) - floor) · W(n)/W(1) / (n · (T(n) - floor))

    with ``W(n) = n · padded_slots_per_shard(n)``, the padded work the plan
    runs at n ranks, and ``floor`` this run's launch floor
    (:func:`..utils.trace.measure_dispatch_floor`).  ``meets_target`` reads
    the normalised column.

    ``engine`` ∈ {"esc", "ell"} × ``b_layout`` ∈ {"replicated", "sharded",
    "ring"}.  ``device_counts`` defaults to the powers of two up to the card
    count (the cores, on the CPU; inside a group, those below its size and
    the size).  Outside a process group the ranks are
    started here (:func:`.launch.launch`, over NCCL with a card a rank, else
    gloo); inside one (``torchrun``, a launched rank) the group's ranks run
    the counts, and every rank must call this.  ``verify=True`` runs
    :func:`.dist_spgemm.dist_spgemm` at the largest count and sets
    ``bit_exact`` from the scipy oracle."""
    if engine not in ("esc", "ell"):
        raise ValueError(f"unknown engine {engine!r}")
    if b_layout not in ("replicated", "sharded", "ring"):
        raise ValueError(f"unknown b_layout {b_layout!r}")
    b = a if b is None else b
    device = resolve_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    world = make_row_mesh(device=device) if dist.is_initialized() else None
    if device_counts is None:
        if world is not None:
            device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d < world.size]
            device_counts.append(world.size)
        else:
            n_avail = cards if cards is not None else (os.cpu_count() or 1)
            device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]
    counts = [int(d) for d in device_counts]
    if not counts or min(counts) < 1:
        raise ValueError(f"device_counts {device_counts} must be positive")
    kw = dict(engine=engine, b_layout=b_layout, counts=counts, balance=balance,
              times=times, verify=verify, cards=cards)
    if world is not None:
        if max(counts) > world.size:
            raise ValueError(f"device_counts {counts} exceed the group's "
                             f"{world.size} ranks")
        return _report(world, a, b, **kw)
    if max(counts) == 1:
        return _report(make_row_mesh(1, device=device), a, b, **kw)
    from .launch import launch

    return launch(_report_rank, max(counts), a, b, kw, device=device,
                  timeout=3600.0)[0]


def format_scaling_report(rep: dict) -> str:
    """The report as the JAX package's table: one line a rank count."""
    lines = [
        f"scaling report: n={rep['n']} nnz={rep['input_nnz']} "
        f"flops={rep['flops']} platform={rep['platform']} "
        f"engine={rep.get('engine', 'esc')} "
        f"b_layout={rep.get('b_layout', 'replicated')}",
        f"{'devices':>8} {'step_s':>10} {'compute_s':>10} "
        f"{'collective_s':>12} {'speedup':>8} {'efficiency':>10} "
        f"{'eff_norm':>9} {'work':>6}",
    ]
    for r in rep["rows"]:
        comp = (f"{r['compute_s']:>10.5f}" if r["compute_s"] is not None
                else f"{'-':>10}")
        coll = (f"{r['collective_s']:>12.5f}" if r["collective_s"] is not None
                else f"{'-':>12}")
        en = r.get("efficiency_norm")
        en_s = f"{en:>9.2%}" if en is not None else f"{'-':>9}"
        wr = r.get("work_vs_1dev")
        wr_s = f"{wr:>6.2f}" if wr is not None else f"{'-':>6}"
        lines.append(
            f"{r['devices']:>8} {r['step_s']:>10.5f} {comp} "
            f"{coll} {r['speedup']:>8.2f} "
            f"{r['efficiency']:>10.2%} {en_s} {wr_s}"
        )
    lines.append(
        f"target >= {rep['efficiency_target']:.0%} (normalized) for N>=2: "
        + ("MET" if rep["meets_target"] else "NOT MET")
    )
    if rep.get("artifact_note"):
        lines.append(f"note: {rep['artifact_note']}")
    return "\n".join(lines)
