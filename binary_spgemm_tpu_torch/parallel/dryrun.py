"""The distributed layer's dryrun: every ported path once, bit-exact.

    python -m binary_spgemm_tpu_torch.parallel.dryrun 4 [--device cpu]

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``: its
19 paths under its names and in its order, at its 8-device sizes (A of 128
x 128, the wide cases 4,800 rows, the closure input 243 x 243) in S ranks:
:func:`.dist_spgemm.dist_spgemm` over every B layout and engine, the masked,
fused-OR (with and without a mask) and union ops, the counting family at
both engines, the masked counts and the triangle count, the three ELL plan
guards (the batched sub-chunk plan, a power-law A through it, and the
``BATCHED_MAX_SLOTS`` skew guard's unrolled re-plan) and the one-sort
closure (:mod:`.dist_onesort`), each against its oracle on every rank:
scipy's product, its int64 product for the counts, the trace of the cubed
adjacency for the triangles, the host closure.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

__all__ = ["PATHS", "dryrun_multichip", "dryrun_paths"]

PATHS = tuple(
    [f"dist_spgemm[{lay},{eng}]" for lay in ("replicated", "sharded", "ring")
     for eng in ("esc", "ell")]
    + ["dist_masked_spgemm[esc]", "dist_masked_spgemm[ell]", "dist_spgemm_or",
       "dist_spgemm_or[masked]", "dist_spm_or", "dist_spgemm_counts[esc]",
       "dist_spgemm_counts[ell]", "dist_masked_spgemm_counts", "dist_triangle_count",
       "dist_spgemm[ell,batched-2d-spmd]", "dist_spgemm[ell,rmat-batched-spmd]",
       "dist_spgemm[ell,skew-guard-fallback]", "dist_transitive_closure[one-sort]"]
)

N = 128  # A, F and D are N x N
WIDE_N = 4800  # rows of the wide-column cases
WIDE_M = 1 << 24  # n_cols 2^24: a packed row cap of 32 rows a sub-chunk
CLOSURE_N = 243  # the closure input: BCSR.random(243, 243, 1.2, seed=9)


def _counts_equal(got, want) -> bool:
    """``(BCSR, counts)`` against a sorted scipy int64 CSR."""
    c, counts = got
    return (np.array_equal(np.asarray(c.indptr, np.int64), want.indptr)
            and np.array_equal(c.indices, want.indices)
            and np.array_equal(counts, want.data))


def dryrun_paths(mesh) -> list[tuple[str, bool]]:
    """Run every path of :data:`PATHS` on this rank (all ranks together);
    return ``[(path, bit-exact)]``."""
    from ..formats.bcsr import BCSR
    from ..ops import ell as ell_mod
    from ..ops.graph import transitive_closure
    from ..ops.spgemm import row_flops
    from ..utils.oracle import masked_spgemm_oracle, spgemm_oracle, union_oracle
    from .dist_onesort import dist_transitive_closure
    from .dist_spgemm import (
        _shard_ell_operands,
        dist_masked_spgemm,
        dist_masked_spgemm_counts,
        dist_spgemm,
        dist_spgemm_counts,
        dist_spgemm_or,
        dist_spm_or,
        dist_triangle_count,
    )
    from .mesh import partition_rows

    a = BCSR.random(N, N, 2.0, seed=0)
    f = BCSR.random(N, N, 3.0, seed=1)
    d = BCSR.random(N, N, 1.0, seed=2)
    want = spgemm_oracle(a, a)
    want_masked = masked_spgemm_oracle(f, a, a)
    sp = a.to_scipy().astype(np.int64)
    want_counts = sp @ sp
    want_counts.sort_indices()
    want_mc = want_counts.multiply(f.to_scipy().astype(np.int64)).tocsr()
    want_mc.sort_indices()
    want_mc.eliminate_zeros()
    # the symmetric, hollow adjacency of the triangle path
    sym = union_oracle(a, a.transpose()).to_dense().copy()
    np.fill_diagonal(sym, False)
    adj = BCSR.from_dense(sym)
    want_tri = int(np.trace(np.linalg.matrix_power(sym.astype(np.int64), 3))) // 6
    checks = []

    def check(got, want_mat):
        checks.append(got.equals(want_mat))

    for lay in ("replicated", "sharded", "ring"):
        for eng in ("esc", "ell"):
            check(dist_spgemm(a, a, mesh, b_layout=lay, engine=eng), want)
    for eng in ("esc", "ell"):
        check(dist_masked_spgemm(f, a, a, mesh, engine=eng), want_masked)
    check(dist_spgemm_or(d, a, a, mesh), union_oracle(d, want))
    check(dist_spgemm_or(d, a, a, mesh, mask=f), union_oracle(d, want_masked))
    check(dist_spm_or(d, a, mesh), union_oracle(d, a))
    for eng in ("esc", "ell"):
        checks.append(_counts_equal(dist_spgemm_counts(a, a, mesh, engine=eng),
                                    want_counts))
    checks.append(_counts_equal(dist_masked_spgemm_counts(f, a, a, mesh), want_mc))
    checks.append(dist_triangle_count(adj, mesh) == want_tri)

    def plan(x, y):
        rf = row_flops(x, y)
        bounds = partition_rows(rf, mesh.size, balance="flops")
        return _shard_ell_operands(x, y, mesh.size, bounds, rf, allow_batched=True)

    # (a) past 16 packed sub-chunks a shard: the batched [C, sort_pad] plan
    wa = BCSR.random(WIDE_N, WIDE_N, 2.0, seed=3)
    wb = BCSR.random(WIDE_N, WIDE_M, 2.0, seed=4)
    if not plan(wa, wb)[-1]:
        raise AssertionError("the wide-column case did not take the batched plan")
    check(dist_spgemm(wa, wb, mesh, engine="ell"), spgemm_oracle(wa, wb))
    # (b) a power-law A through it, then (c) the skew guard lowered to below
    # that plan's resident slots: the unrolled re-plan
    sa = BCSR.rmat((WIDE_N - 1).bit_length(), 2.0, seed=5)
    sb = BCSR.random(sa.n_cols, WIDE_M, 2.0, seed=6)
    plan_s = plan(sa, sb)
    if not plan_s[-1]:
        raise AssertionError("the rmat wide case did not plan batched")
    want_skew = spgemm_oracle(sa, sb)
    check(dist_spgemm(sa, sb, mesh, engine="ell"), want_skew)
    cap0 = ell_mod.BATCHED_MAX_SLOTS
    try:
        ell_mod.BATCHED_MAX_SLOTS = max(plan_s[6] * (plan_s[7].shape[1] - 1) - 1, 1)
        if plan(sa, sb)[-1]:
            raise AssertionError("the skew guard did not re-plan unrolled")
        check(dist_spgemm(sa, sb, mesh, engine="ell"), want_skew)
    finally:
        ell_mod.BATCHED_MAX_SLOTS = cap0
    # the one-sort closure: every rank's rounds read the others' uncompacted
    # streams
    ga = BCSR.random(CLOSURE_N, CLOSURE_N, 1.2, seed=9).sum_duplicates()
    check(dist_transitive_closure(ga, mesh), transitive_closure(ga, device="cpu"))
    return list(zip(PATHS, checks, strict=True))


def dryrun_multichip(n_ranks: int, *, device: str = "cuda") -> list[list]:
    """:func:`dryrun_paths` on ``n_ranks`` launched ranks (NCCL with a card
    a rank, else gloo); prints each path and raises ``AssertionError`` if
    any rank's result differs from scipy's.  Returns every rank's ``[(path,
    ok)]``."""
    from .launch import default_backend, launch

    res = launch(dryrun_paths, n_ranks, device=device, timeout=600.0)
    bad = sorted({name for checks in res for name, ok in checks if not ok})
    for name in PATHS:
        print(f"  {name}: {'MISMATCH' if name in bad else 'OK'}")
    if bad:
        raise AssertionError(f"distributed mismatches: {bad}")
    print(f"dryrun OK: {n_ranks} ranks ({default_backend(n_ranks, device)}, "
          f"{device}), A=({N}, {N}); {len(PATHS)} paths bit-exact on every rank")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="binary_spgemm_tpu_torch.parallel.dryrun")
    p.add_argument("ranks", type=int, nargs="?", default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
