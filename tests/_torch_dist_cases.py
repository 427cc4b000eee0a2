"""Rank side of the distributed layer's CPU tests.

The test modules launch ranks (``binary_spgemm_tpu_torch.parallel.launch``)
that run :func:`run_cases`; spawned ranks import this module, so it imports
neither JAX nor the JAX package.
"""
import importlib

import numpy as np


def step_record(step, sub_bounds) -> dict:
    """A rank's :class:`Step` on the host: pointers, each sub-chunk's valid
    indices (and counts payload, where the step has one), the valid counts,
    the total and the sub-chunk bounds."""
    nnz = step.nnz.cpu().numpy()
    idx = step.c_idx.cpu().numpy()
    rec = {"c_ptr": step.c_ptr.cpu().numpy(), "nnz": nnz,
           "idx": [idx[c, : nnz[c]] for c in range(len(nnz))],
           "total": step.total, "sub_bounds": np.asarray(sub_bounds)}
    if step.cnt is not None:
        cnt = step.cnt.cpu().numpy()
        rec["cnt"] = [cnt[c, : nnz[c]] for c in range(len(nnz))]
    return rec


def run_cases(mesh, cases) -> dict:
    """Run each ``(name, module, function, args, kwargs, patches)`` case on
    this rank (``mesh=`` passed by keyword); ``patches`` are ``(module,
    attribute, value)`` set for the call only.  Returns ``{name: {"c":
    result, "steps": [step_record per assembly], "pulls": [the one-sort
    state each final pull received]}}``, or ``{name: {"error": "Type:
    message"}}`` where the call raised (on every rank alike, or the others
    wait in a collective until the launch's time limit)."""
    from binary_spgemm_tpu_torch.parallel import dist_onesort as do
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as dm

    out = {}
    assemble, pull = dm._assemble, do._pull
    for name, module, fn, args, kwargs, patches in cases:
        steps, pulls = [], []

        def capture(step, sub_bounds, shape, mesh_):
            steps.append(step_record(step, sub_bounds))
            return assemble(step, sub_bounds, shape, mesh_)

        def capture_pull(state, *rest):
            pulls.append({k: t.cpu().numpy() for k, t in zip(("cols", "pos", "nnz"), state)})
            return pull(state, *rest)

        saved = []
        for mod, attr, value in patches:
            m = importlib.import_module(mod)
            saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, value)
        dm._assemble, do._pull = capture, capture_pull
        try:
            fn_ = getattr(importlib.import_module(module), fn)
            out[name] = {"c": fn_(*args, mesh=mesh, **kwargs), "steps": steps,
                         "pulls": pulls}
        except (ValueError, OverflowError) as err:
            out[name] = {"error": f"{type(err).__name__}: {err}"}
        finally:
            dm._assemble, do._pull = assemble, pull
            for m, attr, value in saved:
                setattr(m, attr, value)
    return out


def reduce_facts(mesh) -> dict:
    """One int64 all-reduce of ``[rank, 2**40 + rank]`` on this rank's
    device, the device of its result, and the collectives' counters over
    it."""
    import torch

    from binary_spgemm_tpu_torch.parallel import comm

    comm.reset_counters()
    x = torch.tensor([mesh.rank, (1 << 40) + mesh.rank], dtype=torch.int64,
                     device=mesh.device)
    got = comm.all_reduce_sum(x, mesh)
    return {"sum": got.cpu().numpy(), "input": x.cpu().numpy(), "device": str(got.device),
            "backend": mesh.backend, "counters": dict(comm.counters)}


def mesh_facts(mesh) -> dict:
    """What a launched rank sees of its group: its mesh, the default-group
    mesh, ``initialize`` again (a no-op), a barrier, its row range, and the
    collectives' counters over one gather, one host gather (summed) and one
    ring step."""
    import torch

    from binary_spgemm_tpu_torch.parallel import comm, multihost
    from binary_spgemm_tpu_torch.parallel.mesh import partition_rows

    multihost.initialize(backend="gloo")  # already up: nothing happens
    g = multihost.global_row_mesh(device="cpu")
    multihost.barrier("test")
    comm.reset_counters()
    x = torch.full((3,), mesh.rank, dtype=torch.int32)
    gathered = comm.all_gather(x, mesh)
    summed = comm.all_gather_host(x, mesh).sum(0)
    got = comm.RingShift(x, mesh).wait()
    return {
        "rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
        "global": (g.rank, g.size), "device": str(mesh.device),
        "range": multihost.process_row_range(partition_rows(np.ones(100), mesh.size),
                                             mesh),
        "gathered": gathered.numpy(), "summed": summed.numpy(), "ring": got.numpy(),
        "counters": dict(comm.counters),
    }


def raise_on_rank(mesh, bad: int):
    """Rank ``bad`` raises; the others wait at a barrier that never ends."""
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    from binary_spgemm_tpu_torch.parallel import multihost

    multihost.barrier()


def sleep_forever(mesh):
    import time

    time.sleep(3600)


def from_local(mesh, path: str, b, n: int) -> dict:
    """Each rank reads only its row range of ``path`` (under the rows- and
    the flops-balanced partitions) and multiplies it by the replicated B
    (``dist_spgemm_from_local``); also what the rank sees of the group."""
    from binary_spgemm_tpu_torch.io.mmio import read_pattern
    from binary_spgemm_tpu_torch.ops.spgemm import row_flops
    from binary_spgemm_tpu_torch.parallel import multihost
    from binary_spgemm_tpu_torch.parallel.mesh import partition_rows

    multihost.initialize(backend="gloo")  # already up: nothing happens
    g = multihost.global_row_mesh(device="cpu")
    multihost.barrier("pre-local")
    whole = read_pattern(path, transpose=False)
    cases, ranges = [], {}
    for balance, w in (("rows", np.ones(n)), ("flops", row_flops(whole, b))):
        bounds = partition_rows(w, mesh.size, balance=balance)
        lo, hi = multihost.process_row_range(bounds, mesh)
        ranges[balance] = (lo, hi)
        a_local = read_pattern(path, transpose=False, row_range=(lo, hi))
        cases.append((balance, "binary_spgemm_tpu_torch.parallel.multihost",
                      "dist_spgemm_from_local", (a_local, bounds, b), {}, ()))
    out = run_cases(mesh, cases)
    multihost.barrier("post-local")
    return {"results": out, "ranges": ranges, "global": (g.rank, g.size, g.backend)}


def scaling_reports(mesh, a, combos, kwargs) -> dict:
    """``scaling_report`` of each ``(engine, b_layout)`` in ``combos`` on
    this rank's group (every rank calls it; the report is rank 0's)."""
    from binary_spgemm_tpu_torch.parallel.scaling import scaling_report

    return {combo: scaling_report(a, engine=combo[0], b_layout=combo[1],
                                  device=mesh.device, **kwargs)
            for combo in combos}


def native_threads(mesh) -> tuple:
    """This rank's ``LOCAL_WORLD_SIZE`` and the native tier's thread count."""
    import os

    from binary_spgemm_tpu_torch import native

    return os.environ.get("LOCAL_WORLD_SIZE"), native.threads()
