"""The port's multi-process glue (``parallel/multihost.py``) against the JAX
package's: ``tests/test_multihost.py``'s single-process checks, and the
sharded-ingest pipeline in two gloo ranks on the CPU, each rank reading only
its ``row_range`` of one written ``.mtx`` (``dist_spgemm_from_local``), its
result bit-exact against scipy and JAX's (run in one process on a 2-device
mesh, where this process owns every row), and its step outputs
element-equal to JAX's shard of them."""
import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.parallel import dist_spgemm as jd
from binary_spgemm_tpu.parallel import multihost as jx_mh
from binary_spgemm_tpu.parallel.mesh import make_row_mesh as jx_mesh

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops.spgemm import row_flops
from binary_spgemm_tpu_torch.parallel import multihost
from binary_spgemm_tpu_torch.parallel.launch import launch
from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh, partition_rows
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

import _torch_dist_cases

N = 200
S = 2


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def test_global_row_mesh_alone():
    mesh = multihost.global_row_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert jx_mh.global_row_mesh().devices.size == 8  # the JAX side's 8 devices


def test_barrier_single_process():
    multihost.barrier("test")  # no group: a no-op that must not hang
    jx_mh.barrier("test")


def test_process_row_range_covers_all_rows():
    bounds = partition_rows(np.ones(100), 1)
    assert multihost.process_row_range(bounds, make_row_mesh(device="cpu")) == (0, 100)
    assert jx_mh.process_row_range(partition_rows(np.ones(100), 8), jx_mesh()) == (0, 100)


def test_from_local_checks_its_inputs():
    a = tp.BCSR.random(N, N, 2.0, seed=5)
    mesh = make_row_mesh(device="cpu")
    with pytest.raises(ValueError, match="shards"):
        multihost.dist_spgemm_from_local(a, [0, 100, N], a, mesh)
    with pytest.raises(ValueError, match="rows"):
        multihost.dist_spgemm_from_local(a, [0, N + 1], a, mesh)
    c = multihost.dist_spgemm_from_local(a, [0, N], a, mesh)
    assert c.equals(spgemm_oracle(a, a))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    ja = jx.BCSR.random(N, N, 3.0, seed=5)
    path = str(tmp_path_factory.mktemp("mh") / "a.mtx")
    jx.write_pattern(path, ja)
    return path, ja


@pytest.fixture(scope="module")
def ranks(written):
    path, ja = written
    return launch(_torch_dist_cases.from_local, S, path, to_port(ja), N, device="cpu",
                  timeout=120)


def jax_from_local(ja, bounds):
    steps = []
    orig = jd._assemble_sharded

    def capture(c_ptr, c_idx, nnz, total, b, shape, c_cnt=None):
        steps.append((np.asarray(c_ptr), np.asarray(c_idx), np.asarray(nnz)[:, 0]))
        return orig(c_ptr, c_idx, nnz, total, b, shape, c_cnt)

    jd._assemble_sharded = capture
    try:
        mesh = jx_mesh(S)
        lo, hi = jx_mh.process_row_range(bounds, mesh)  # one process: every row
        assert (lo, hi) == (0, N)
        c = jx_mh.dist_spgemm_from_local(ja, bounds, ja, mesh)
    finally:
        jd._assemble_sharded = orig
    return c, steps[0]


def test_ranks_join_one_group(ranks):
    for r, res in enumerate(ranks):
        assert res["global"] == (r, S, "gloo")


@pytest.mark.parametrize("balance", ["rows", "flops"])
def test_from_local_reads_its_rows_only(ranks, written, balance):
    path, ja = written
    a = to_port(ja)
    weights = np.ones(N) if balance == "rows" else row_flops(a, a)
    bounds = partition_rows(weights, S, balance=balance)
    want = spgemm_oracle(a, a)
    c_jax, (j_ptr, j_idx, j_nnz) = jax_from_local(ja, bounds)
    assert to_port(c_jax).equals(want)
    for r, res in enumerate(ranks):
        assert res["ranges"][balance] == (int(bounds[r]), int(bounds[r + 1]))
        got = res["results"][balance]
        assert got["c"].equals(want), got["c"].diff(want)
        (step,) = got["steps"]
        assert np.array_equal(step["c_ptr"][0], j_ptr[r])
        assert step["nnz"][0] == j_nnz[r]
        assert np.array_equal(step["idx"][0], j_idx[r, : j_nnz[r]])
