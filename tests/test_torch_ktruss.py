"""The device-resident k-truss peel (``k_truss(resident=True)``,
``ops/truss.py``) on the CPU: bit-equal to the benchmark's plain reference
(``spgemm_bench/ktruss_reference.py``), to the host loop
(``resident=False``) and to the JAX package's ``k_truss``, on seeded random
graphs, a Kronecker graph of a long peel, each plan form (the unrolled and
the batched masked ELL plans, a key that does not pack, ESC), a graph whose
truss is empty and a clique with pendant edges; the live-leg rule; the
layout's own check; the input errors."""
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import graph as jx_graph

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import ell, truss
from binary_spgemm_tpu_torch.ops import graph as tp_graph
from spgemm_bench import gen, ktruss_reference

CPU = "cpu"
KRON9 = {"generator": "kronecker", "structure_seed": 1, "scale": 9, "edge_factor": 8,
          "a": 0.57, "b": 0.19, "c": 0.19, "symmetric": True, "self_loops": False}


def sym_graph(n, d, seed):
    s = tp.BCSR.random(n, n, d, seed=seed).to_scipy()
    s = ((s + s.T) > 0).astype(np.int64).tolil()
    s.setdiag(0)
    return tp.BCSR.from_scipy(s.tocsr())


def from_edges(n, edges):
    rows = [i for a, b in edges for i in (a, b)]
    cols = [j for a, b in edges for j in (b, a)]
    return tp.BCSR.from_coo(np.array(rows), np.array(cols), (n, n)).sum_duplicates()


def assert_same(want, got):
    assert tuple(want.shape) == tuple(got.shape)
    assert np.array_equal(want.indptr, got.indptr)
    assert np.array_equal(want.indices, got.indices)


_JAX_TRUSS = {}


def check_all_routes(g, k, **kw):
    """The resident peel against the reference, the host loop and the JAX
    package's ``k_truss`` (its default route, once a graph and k: its
    compiles cost seconds a shape); returns the truss and the reference's
    round count."""
    got = tp_graph.k_truss(g, k, device=CPU, **kw)
    ref = ktruss_reference.peel(g.indptr, g.indices, g.n_rows, k, CPU)
    assert np.array_equal(ref.indptr, got.indptr) and np.array_equal(ref.indices, got.indices)
    assert_same(tp_graph.k_truss(g, k, resident=False, device=CPU, **kw), got)
    key = (g.shape, g.indptr.tobytes(), g.indices.tobytes(), k)
    if key not in _JAX_TRUSS:
        _JAX_TRUSS[key] = jx_graph.k_truss(jx.BCSR(g.indptr.copy(), g.indices.copy(),
                                                   g.shape), k)
    assert_same(_JAX_TRUSS[key], got)
    return got, ref.rounds


@pytest.mark.parametrize("k", [3, 4, 5, 8])
@pytest.mark.parametrize("n,d,seed", [(80, 6.0, 0), (150, 10.0, 1)])
def test_random_graphs_on_every_route(n, d, seed, k):
    check_all_routes(sym_graph(n, d, seed), k)


@pytest.fixture
def kron9():
    indptr, indices, n = gen.generate(KRON9, 5)
    return tp.BCSR(indptr.copy(), indices.copy(), (n, n))


@pytest.mark.parametrize("route", ["unrolled", "batched", "esc"])
@pytest.mark.parametrize("k", [6, 12])
def test_kronecker_long_peel(monkeypatch, kron9, route, k):
    """A peel of at least five rounds on each plan form; the batched plan
    (dealt bins, merged width classes) at this size by the many-rows rule
    patched.  Each later ELL round's spans hold every live entry of A."""
    monkeypatch.setattr(ell, "prefer_batched", lambda a, b: route == "batched")
    monkeypatch.setattr(ell, "_EXEC_CACHE", {})
    seen = []
    orig = truss._EllLayout.entries

    def entries(self, ex, live_ext, pads):
        out = orig(self, ex, live_ext, pads)
        live = live_ext[:-1]
        placed = torch.isin(out[0], torch.arange(ex.rows_pad, dtype=out[0].dtype))
        seen.append((pads is None, int(placed.sum()),
                     int(live[self.er_eid[self.real.view(-1)].long()].sum())))
        return out

    monkeypatch.setattr(truss._EllLayout, "entries", entries)
    kw = {"chunk_flops": 1 << 16} if route == "esc" else {}
    got, rounds = check_all_routes(kron9, k, **kw)
    assert rounds >= 5 and 0 < got.nnz < kron9.nnz
    if route != "esc":
        ex = ell.cached_executor(kron9, kron9, masked=True, device=CPU)
        assert ex.batched is (route == "batched")
        assert len(seen) == rounds and seen[0][0] and not any(first for first, _, _ in seen[1:])
        assert all(placed == live for _, placed, live in seen)


@pytest.mark.parametrize("chunk_flops", [None, 1 << 14])
def test_pair_keys_where_the_pair_does_not_pack(monkeypatch, kron9, chunk_flops):
    """The int64 pair keys of a plan whose (row, col) pair does not pack
    into int32 (2^21 vertices and more: the masked plan's chunks hold every
    row), driven at this size with the packing rule patched."""
    monkeypatch.setattr(truss, "packable", lambda n_rows, n_cols: False)
    monkeypatch.setattr(ell, "_EXEC_CACHE", {})
    check_all_routes(kron9, 8, chunk_flops=chunk_flops)
    _, lay, _ = truss._route(kron9, chunk_flops, torch.device(CPU))
    assert lay.keys.fill == np.iinfo(np.int64).max


@pytest.mark.parametrize("k", [3, 4, 5, 6])
def test_clique_with_pendant_edges_and_an_empty_truss(k):
    """K5 with a pendant edge on each vertex and a path hanging off vertex
    0: every k up to 5 keeps exactly the clique; k = 6 empties the graph;
    a triangle-free ring is empty at every k."""
    edges = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    edges += [(i, 5 + i) for i in range(5)] + [(0, 10), (10, 11), (11, 12)]
    g = from_edges(13, edges)
    got, _ = check_all_routes(g, k)
    clique = from_edges(13, edges[:10])
    if k <= 5:
        assert_same(clique, got)
    else:
        assert got.nnz == 0
    ring = from_edges(9, [(i, (i + 1) % 9) for i in range(9)])
    got, rounds = check_all_routes(ring, k)
    assert got.nnz == 0 and rounds == 1


@pytest.mark.parametrize("chunk_flops", [None, 64])
def test_a_dead_leg_kills_its_wedges(chunk_flops):
    """K5 on 0-4 and a fan off vertex 4 (the path 5-6-7, each joined to 4):
    at k = 4 the edge (4, 6) keeps its two triangles through the first
    round, whose other edges all drop there, so the second round must see
    it with no live wedge and drop it; the third drops nothing."""
    edges = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    edges += [(4, 5), (4, 6), (4, 7), (5, 6), (6, 7)]
    g = from_edges(8, edges)
    ref = ktruss_reference.peel(g.indptr, g.indices, 8, 4, CPU, max_rounds=1)
    assert 4 * 8 + 6 in set(np.repeat(np.arange(8), np.diff(ref.indptr)) * 8 + ref.indices)
    got, rounds = check_all_routes(g, 4, chunk_flops=chunk_flops)
    assert rounds == 3
    assert_same(from_edges(8, edges[:10]), got)


def test_the_layout_refuses_a_plan_it_does_not_match(monkeypatch, kron9):
    """Each staged slot of the plan is held against the entry the layout
    maps it to: a plan whose placement moved raises instead of peeling the
    wrong legs."""
    monkeypatch.setattr(ell, "_EXEC_CACHE", {})
    ex = ell.cached_executor(kron9, kron9, masked=True, device=CPU)
    ex.er_all = ex.er_all.flip(1)
    with pytest.raises(RuntimeError, match="does not match the staged masked plan"):
        tp_graph.k_truss(kron9, 8, device=CPU)


def test_input_errors():
    g = sym_graph(50, 4.0, 3)
    for resident in (True, False):
        with pytest.raises(ValueError, match="k >= 3"):
            tp_graph.k_truss(g, 2, resident=resident, device=CPU)
        with pytest.raises(ValueError, match="square"):
            tp_graph.k_truss(tp.BCSR.random(30, 40, 2.0, seed=1), 3, resident=resident,
                             device=CPU)
    empty = tp.BCSR(np.zeros(6, np.int32), np.zeros(0, np.int32), (5, 5))
    assert tp_graph.k_truss(empty, 3, device=CPU).nnz == 0
