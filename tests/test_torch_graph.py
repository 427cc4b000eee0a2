"""The port's graph ops (``ops/graph.py``) against the JAX package's, on the
CPU: the same seeded graphs through both, every result exactly equal — the
k-hop powers and closures on all three of the port's routes (host, resident
compacted, resident one-sort), BFS levels, triangle structure and counts,
clustering coefficients (``assert_array_equal``) and k-trusses — and equal
to scipy.  The resident routes are held against the JAX package's host
route, which its own tests hold equal to its resident routes.  Also the
overflow guard (where it falls, against the JAX package's helpers), the
one-sort ratio gate, the validation errors and the ``resident=`` /
``device=`` names."""
import inspect

import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import graph as jx_graph
from binary_spgemm_tpu.ops import onesort as jx_os
from binary_spgemm_tpu.ops import spgemm as jx_sp

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import device_api as tp_api
from binary_spgemm_tpu_torch.ops import graph as tp_graph
from binary_spgemm_tpu_torch.ops import onesort as tp_os
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

CPU = "cpu"
ROUTES = {"host": {}, "resident": {"resident": True, "one_sort": False},
          "one-sort": {"resident": True}}


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def ring(n):
    rows = np.arange(n)
    return jx.BCSR.from_coo(rows, (rows + 1) % n, (n, n))


def sym_graph(n, d, seed):
    sp = jx.BCSR.random(n, n, d, seed=seed).to_scipy()
    sp = ((sp + sp.T) > 0).astype(np.int64).tolil()
    sp.setdiag(0)
    return jx.BCSR.from_scipy(sp.tocsr())


def assert_same(j, t):
    assert tuple(j.shape) == tuple(t.shape)
    assert np.array_equal(j.indptr, t.indptr) and np.array_equal(j.indices, t.indices)


def closure_oracle(a):
    """R <- R OR R·R to the fixpoint, with scipy."""
    r = (a.to_scipy() > 0).astype(np.int64)
    while True:
        nxt = ((r + r @ r) > 0).astype(np.int64)
        if nxt.nnz == r.nnz:
            return jx.BCSR.from_scipy(r.tocsr())
        r = nxt


@pytest.mark.parametrize("route", list(ROUTES))
def test_k_hop_ring(route):
    a = to_port(ring(10))
    for k in (1, 2, 3, 7):
        dense = np.zeros((10, 10), bool)
        dense[np.arange(10), (np.arange(10) + k) % 10] = True
        got = tp_graph.k_hop(a, k, device=CPU, **ROUTES[route])
        np.testing.assert_array_equal(got.to_dense(), dense)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed,n,d,k", [(1, 80, 2.0, 3), (21, 150, 2.0, 3),
                                        (22, 80, 1.5, 5), (23, 60, 3.0, 1),
                                        (10, 500, 2.0, 2)])
def test_k_hop_matches_jax(route, seed, n, d, k):
    a = jx.BCSR.random(n, n, d, seed=seed)
    want = jx_graph.k_hop(a, k)
    got = tp_graph.k_hop(to_port(a), k, device=CPU, **ROUTES[route])
    assert_same(want, got)
    ref = a.sum_duplicates()
    for _ in range(k - 1):
        ref = spgemm_oracle(ref, a)
    assert got.equals(to_port(ref))


def test_k_hop_through_esc_matches_jax():
    # chunk_flops forces the port's host route through its ESC engine
    a = jx.BCSR.random(200, 200, 3.0, seed=5)
    assert_same(jx_graph.k_hop(a, 3),
                tp_graph.k_hop(to_port(a), 3, chunk_flops=4096, device=CPU))


def test_k_hop_validation():
    a = to_port(jx.BCSR.random(20, 20, 2.0, seed=1))
    for kw in ROUTES.values():
        with pytest.raises(ValueError, match="k must be"):
            tp_graph.k_hop(a, 0, device=CPU, **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_transitive_closure_ring_and_dag(route):
    assert tp_graph.transitive_closure(to_port(ring(8)), device=CPU,
                                       **ROUTES[route]).nnz == 64
    a = tp.BCSR.from_coo(np.array([0, 1, 2]), np.array([1, 2, 3]), (4, 4))
    np.testing.assert_array_equal(
        tp_graph.transitive_closure(a, device=CPU, **ROUTES[route]).to_dense(),
        np.triu(np.ones((4, 4), bool), 1))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed,n,d", [(11, 60, 1.5), (12, 200, 0.8), (13, 90, 2.5)])
def test_transitive_closure_matches_jax(route, seed, n, d):
    a = jx.BCSR.random(n, n, d, seed=seed)
    want = jx_graph.transitive_closure(a)
    got = tp_graph.transitive_closure(to_port(a), device=CPU, **ROUTES[route])
    assert_same(want, got)
    assert got.equals(to_port(closure_oracle(a)))


@pytest.mark.parametrize("route", list(ROUTES))
def test_transitive_closure_max_iters_matches_jax(route):
    a = jx.BCSR.random(120, 120, 1.2, seed=14)
    assert_same(jx_graph.transitive_closure(a, max_iters=2),
                tp_graph.transitive_closure(to_port(a), max_iters=2, device=CPU,
                                            **ROUTES[route]))


def test_transitive_closure_through_esc_matches_jax():
    a = jx.BCSR.random(150, 150, 1.2, seed=15)
    assert_same(jx_graph.transitive_closure(a),
                tp_graph.transitive_closure(to_port(a), chunk_flops=2048, device=CPU))


@pytest.mark.parametrize("route", list(ROUTES))
def test_transitive_closure_past_the_host_engine(route):
    # the late rounds pass HOST_MAX_FLOPS, so the host route runs the
    # sliced-ELL executor (the JAX package's host route would compile its
    # own here, so this case holds the port against scipy alone)
    a = jx.BCSR.random(250, 250, 1.5, seed=9)
    want = closure_oracle(a)
    assert jx_sp.spgemm_flops(want, want) > 2_000_000
    got = tp_graph.transitive_closure(to_port(a), device=CPU, **ROUTES[route])
    assert got.equals(to_port(want))


def test_closure_needs_a_square_matrix():
    a = to_port(jx.BCSR.random(20, 30, 2.0, seed=1))
    for kw in ROUTES.values():
        with pytest.raises(ValueError, match="square"):
            tp_graph.transitive_closure(a, device=CPU, **kw)


def test_onesort_compact_ratio_gate(monkeypatch):
    # a gate of 0 compacts after every round; the result must not change
    a = jx.BCSR.random(120, 120, 1.5, seed=11)
    want = jx_graph.transitive_closure(a)
    monkeypatch.setattr(tp_graph, "ONESORT_COMPACT_RATIO", 0.0)
    assert_same(want, tp_graph.transitive_closure(to_port(a), resident=True, device=CPU))
    assert_same(jx_graph.k_hop(a, 5), tp_graph.k_hop(to_port(a), 5, resident=True,
                                                     device=CPU))


def test_plan_constants_are_the_jax_packages():
    assert tp_graph.DEVICE_CLOSURE_MAX_FLOPS == jx_graph.DEVICE_CLOSURE_MAX_FLOPS == 1 << 28
    assert tp_graph.ONESORT_COMPACT_RATIO == jx_graph.ONESORT_COMPACT_RATIO == 2.0


@pytest.mark.parametrize("one_sort", [False, True])
@pytest.mark.parametrize("op", ["closure", "khop"])
def test_resident_overflow_guard(monkeypatch, op, one_sort):
    monkeypatch.setattr(tp_graph, "DEVICE_CLOSURE_MAX_FLOPS", 64)
    a = to_port(jx.BCSR.random(100, 100, 3.0, seed=15))
    with pytest.raises(OverflowError, match="resident budget"):
        if op == "closure":
            tp_graph.transitive_closure(a, resident=True, one_sort=one_sort, device=CPU)
        else:
            tp_graph.k_hop(a, 2, resident=True, one_sort=one_sort, device=CPU)
    # the host route has no resident budget
    assert tp_graph.k_hop(a, 2, device=CPU).equals(spgemm_oracle(a, a))


@pytest.mark.parametrize("margin", [-1, 1])
def test_guard_falls_where_the_jax_packages_does(monkeypatch, margin):
    # the float32 estimates are the JAX package's, so with the budget set
    # just below or above 0.98 x the bound both raise or both pass
    a = jx.BCSR.random(400, 400, 4.0, seed=16).sum_duplicates()
    ja = jx_sp.DeviceBCSR.from_host(a)
    ta = tp_sp.DeviceBCSR.from_host(to_port(a), device=CPU)
    pj = jx_os.PaddedDeviceBCSR.from_device(ja)
    pt = tp_os.PaddedDeviceBCSR.from_device(ta)
    flops = jx_sp.spgemm_flops(a, a)
    budget = int(flops / 0.98) + margin
    for mod in (jx_graph, tp_graph):
        monkeypatch.setattr(mod, "DEVICE_CLOSURE_MAX_FLOPS", budget)
    for j_call, t_call in (
            (lambda: jx_graph._guarded_flops_pad(jx_graph._step_bound_jit(), ja, ja),
             lambda: tp_graph._guarded_flops_pad(ta, ta)),
            (lambda: jx_graph._onesort_guarded_pad(pj, pj),
             lambda: tp_graph._onesort_guarded_pad(pt, pt))):
        if margin < 0:
            for call in (j_call, t_call):
                with pytest.raises(OverflowError):
                    call()
        else:
            assert t_call() == j_call() == jx_sp.pad_bucket(flops)


def test_onesort_regate_matches_jax(monkeypatch):
    a = jx.BCSR.random(300, 300, 3.0, seed=17).sum_duplicates()
    pj = jx_os.PaddedDeviceBCSR.from_host(a)
    pt = tp_os.PaddedDeviceBCSR.from_host(to_port(a), device=CPU)
    fp = jx_sp.pad_bucket(jx_sp.spgemm_flops(a, a))
    j = jx_os.spgemm_onesort_device(pj, pj, flops_pad=fp)
    t = tp_os.spgemm_onesort_device(pt, pt, flops_pad=fp)
    for ratio in (0.5, 1e9):
        monkeypatch.setattr(jx_graph, "ONESORT_COMPACT_RATIO", ratio)
        monkeypatch.setattr(tp_graph, "ONESORT_COMPACT_RATIO", ratio)
        jr, tr = jx_graph._onesort_regate(j), tp_graph._onesort_regate(t)
        assert (tr is t) == (jr is j) == (ratio > 1)
        assert tr.stream_len == jr.stream_len
        assert np.array_equal(np.asarray(jr.cols), tr.cols.numpy())
        assert np.array_equal(np.asarray(jr.indptr_pos), tr.indptr_pos.numpy())


def test_triangle_structure_and_count_small():
    # K4: every edge is in a triangle, 4 triangles; a 4-cycle has none
    k4 = ~np.eye(4, dtype=bool)
    a = tp.BCSR.from_dense(k4)
    np.testing.assert_array_equal(tp_graph.triangle_structure(a, device=CPU).to_dense(), k4)
    assert tp_graph.triangle_count(a, device=CPU) == 4
    assert tp_graph.triangle_count(a, resident=False) == 4
    sq = np.zeros((4, 4), bool)
    for i in range(4):
        sq[i, (i + 1) % 4] = sq[(i + 1) % 4, i] = True
    b = tp.BCSR.from_dense(sq)
    assert tp_graph.triangle_structure(b, device=CPU).nnz == 0
    assert tp_graph.triangle_count(b, device=CPU) == 0


@pytest.mark.parametrize("chunk_flops", [None, 4096])
@pytest.mark.parametrize("seed", [1, 2])
def test_triangles_match_jax(seed, chunk_flops):
    g = sym_graph(300, 4.0, seed)
    tg = to_port(g)
    assert_same(jx_graph.triangle_structure(g),
                tp_graph.triangle_structure(tg, chunk_flops=chunk_flops, device=CPU))
    want = jx_graph.triangle_count(g, device=False)
    s = g.to_scipy()
    assert want == int(s.multiply(s @ s).sum()) // 6 > 0
    assert tp_graph.triangle_count(tg, chunk_flops=chunk_flops, device=CPU) == want
    assert tp_graph.triangle_count(tg, resident=False) == want


def test_triangle_count_device_route_matches_jax():
    g = sym_graph(120, 4.0, 3)
    assert tp_graph.triangle_count(to_port(g), device=CPU) == jx_graph.triangle_count(g)


def _bfs_oracle(a, sources):
    from scipy.sparse.csgraph import dijkstra

    dist = dijkstra(a.to_scipy(), directed=True, unweighted=True,
                    indices=np.atleast_1d(sources), min_only=True)
    return np.where(np.isinf(dist), -1, dist).astype(np.int32)


def test_bfs_levels_ring():
    np.testing.assert_array_equal(tp_graph.bfs_levels(to_port(ring(8)), 3, device=CPU),
                                  [5, 6, 7, 0, 1, 2, 3, 4])


@pytest.mark.parametrize("chunk_flops", [None, 1024])
@pytest.mark.parametrize("seed,n,d,srcs", [(31, 200, 1.5, 0), (32, 150, 0.5, [3, 77]),
                                           (33, 120, 3.0, [0, 1, 2]), (34, 64, 2.0, [63])])
def test_bfs_levels_match_jax(seed, n, d, srcs, chunk_flops):
    a = jx.BCSR.random(n, n, d, seed=seed)
    got = tp_graph.bfs_levels(to_port(a), srcs, chunk_flops=chunk_flops, device=CPU)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jx_graph.bfs_levels(a, srcs))
    np.testing.assert_array_equal(got, _bfs_oracle(a, srcs))


def test_bfs_levels_max_hops_and_reachable():
    a = to_port(ring(10))
    np.testing.assert_array_equal(tp_graph.bfs_levels(a, 0, max_hops=3, device=CPU),
                                  [0, 1, 2, 3, -1, -1, -1, -1, -1, -1])
    np.testing.assert_array_equal(tp_graph.reachable(a, 0, max_hops=3, device=CPU),
                                  [0, 1, 2, 3])
    b = jx.BCSR.random(90, 90, 2.0, seed=41)
    got = tp_graph.reachable(to_port(b), 5, device=CPU)
    np.testing.assert_array_equal(got, jx_graph.reachable(b, 5))
    np.testing.assert_array_equal(got, np.flatnonzero(_bfs_oracle(b, 5) >= 0))


def test_bfs_levels_validation_and_empty():
    a = to_port(ring(6))
    with pytest.raises(ValueError, match="non-empty"):
        tp_graph.bfs_levels(a, [], device=CPU)
    with pytest.raises(ValueError, match="source ids"):
        tp_graph.bfs_levels(a, 6, device=CPU)
    with pytest.raises(ValueError, match="square"):
        tp_graph.bfs_levels(tp.BCSR.random(4, 5, 1.0, seed=1), 0, device=CPU)
    e = tp.BCSR(np.zeros(7, np.int32), np.zeros(0, np.int32), (6, 6))
    np.testing.assert_array_equal(tp_graph.bfs_levels(e, [2, 4], device=CPU),
                                  [-1, -1, 0, -1, 0, -1])


def test_clustering_coefficients_small():
    # triangle 0-1-2, pendant 3 on 2, isolated 4
    dense = np.zeros((5, 5), bool)
    for i, j in [(0, 1), (1, 2), (0, 2), (2, 3)]:
        dense[i, j] = dense[j, i] = True
    cc = tp_graph.clustering_coefficients(tp.BCSR.from_dense(dense), device=CPU)
    np.testing.assert_array_equal(
        cc, jx_graph.clustering_coefficients(jx.BCSR.from_dense(dense)))
    np.testing.assert_allclose(cc, [1.0, 1.0, 1 / 3, 0.0, 0.0])


@pytest.mark.parametrize("chunk_flops", [None, 4096])
@pytest.mark.parametrize("seed", [9, 10])
def test_clustering_coefficients_match_jax(seed, chunk_flops):
    g = sym_graph(200, 5.0, seed)
    got = tp_graph.clustering_coefficients(to_port(g), chunk_flops=chunk_flops, device=CPU)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jx_graph.clustering_coefficients(g))
    d = g.to_dense().astype(np.int64)
    deg = d.sum(1)
    tri = np.einsum("ij,jk,ki->i", d, d, d)
    want = np.zeros(len(deg))
    nz = deg > 1
    want[nz] = tri[nz] / (deg[nz] * (deg[nz] - 1))
    np.testing.assert_array_equal(got, want)


def test_k_truss_small():
    dense = np.zeros((8, 8), bool)
    for i, j in [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (3, 4), (4, 5), (3, 5),
                 (5, 6), (6, 7)]:
        dense[i, j] = dense[j, i] = True
    g, jg = tp.BCSR.from_dense(dense), jx.BCSR.from_dense(dense)
    for k in (3, 4, 5):
        assert_same(jx_graph.k_truss(jg, k), tp_graph.k_truss(g, k, device=CPU))
    assert tp_graph.k_truss(g, 5, device=CPU).nnz == 0
    with pytest.raises(ValueError, match="k >= 3"):
        tp_graph.k_truss(g, 2, device=CPU)


@pytest.mark.parametrize("chunk_flops", [None, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_k_truss_matches_jax_and_peeling(seed, chunk_flops):
    g = sym_graph(120, 6.0, seed)
    for k in (3, 4):
        got = tp_graph.k_truss(to_port(g), k, chunk_flops=chunk_flops, device=CPU)
        assert_same(jx_graph.k_truss(g, k), got)
        d = g.to_dense().astype(np.int64)
        while True:
            drop = (((d @ d) * d) < k - 2) & (d > 0)
            if not drop.any():
                break
            d[drop] = 0
        np.testing.assert_array_equal(got.to_dense(), d > 0)


def test_entry_points_default_to_cuda():
    # device= is the torch device, "cuda" unless told otherwise; the JAX
    # package's boolean device= is resident= with its defaults
    fns = [tp_graph.k_hop, tp_graph.transitive_closure, tp_graph.bfs_levels,
           tp_graph.reachable, tp_graph.triangle_structure, tp_graph.triangle_count,
           tp_graph.clustering_coefficients, tp_graph.k_truss,
           tp_sp.DeviceBCSR.from_host, tp_os.PaddedDeviceBCSR.from_host]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    defaults = {fn.__name__: inspect.signature(fn).parameters["resident"].default
                for fn in (tp_graph.k_hop, tp_graph.transitive_closure,
                           tp_graph.triangle_count)}
    assert defaults == {"k_hop": False, "transitive_closure": False,
                        "triangle_count": True}
    for name, fn in inspect.getmembers(tp_api, inspect.isfunction):
        assert "device" not in inspect.signature(fn).parameters, name
    if not torch.cuda.is_available():
        a = to_port(jx.BCSR.random(50, 50, 2.0, seed=1))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp_graph.transitive_closure(a, resident=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp_graph.k_hop(a, 2, resident=True, one_sort=False)
