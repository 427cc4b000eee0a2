"""P1/P2, the port's ``bitonic_network_rows``, on the CPU: its plain version
and its CPU wrapper against the JAX package's prototypes —
``benchmarks/pallas_sort.py::make_bitonic`` in interpret mode (P1) and
``benchmarks/ab_wruns.py::make_kernel`` under the TPU interpret mode (P2) — on
random rows with duplicates and int32 extremes and on rows of alternating
sorted runs, against a numpy transcription of the stage loop at ``[8,
4096]``, and the wrapper's contract."""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from binary_spgemm_tpu.ops import bitonic as jx_bitonic

from binary_spgemm_tpu_torch.benchmarks.ab_wruns import alternating_runs
from binary_spgemm_tpu_torch.ops import bitonic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
W = 16


def _load_reference(name: str):
    """A script of the JAX package's ``benchmarks/`` folder, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def make_bitonic():
    return _load_reference("pallas_sort").make_bitonic


@pytest.fixture(scope="module")
def make_kernel():
    """``ab_wruns.make_kernel``.  Importing the script points JAX's
    compilation cache into the repository and puts ``benchmarks/`` on
    ``sys.path``; both are put back at once, so no other test in this
    process inherits them."""
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    old_path = list(sys.path)
    try:
        mod = _load_reference("ab_wruns")
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)
        sys.path[:] = old_path
    assert jax.config.jax_compilation_cache_dir == old_dir
    return mod.make_kernel


def random_rows(k, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64, endpoint=True)
    x = x.astype(np.int32)
    x[0, : L // 2] = x[0, 0]  # duplicates
    x[1, :3] = I32_MAX
    x[-1, :2] = I32_MIN
    x[2] = rng.integers(0, 4, L)  # a row of few values
    return x


def runs_rows(x, w):
    """The reference's precondition verbatim (``ab_wruns.py:78-84``): each
    aligned w-block sorted, descending where ``(start & w) != 0``."""
    k, L = x.shape
    xb = np.sort(x.reshape(k, L // w, w), axis=2)
    desc = (np.arange(L // w) * w & w) != 0
    xb[:, desc, :] = xb[:, desc, ::-1]
    return xb.reshape(k, L)


def both(x, min_kk):
    """The plain version and the CPU wrapper, as numpy arrays."""
    xt = torch.from_numpy(x)
    return (bitonic.bitonic_network_rows_plain(xt, min_kk).numpy(),
            bitonic.bitonic_network_rows(xt, min_kk).numpy())


@pytest.mark.parametrize("k,L,B", [(16, 256, 8), (8, 1024, 4), (32, 512, 8)])
def test_p1_matches_make_bitonic(make_bitonic, k, L, B):
    x = random_rows(k, L, k * L)
    want = np.asarray(make_bitonic(L, B, interpret=True)(jnp.asarray(x)))
    assert np.array_equal(want, np.sort(x, axis=1))
    for got in both(x, 2):
        assert np.array_equal(got, want)


def p2_cases():
    cases = []
    for L in (128, 1024):
        for first in ("2", "4", "32", "L", "2L"):
            for rows in ("random", "runs"):
                cases.append((L, first, rows))
    return cases


@pytest.mark.parametrize("L,first,rows", p2_cases())
def test_p2_matches_make_kernel(make_kernel, L, first, rows):
    min_kk = {"L": L, "2L": 2 * L}.get(first) or int(first)
    k = 16
    B = bitonic._pick_block(k, L)
    x = random_rows(k, L, L + min_kk)
    if rows == "runs":
        x = runs_rows(x, W)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(make_kernel(L, B, min_kk)(jnp.asarray(x)))
    for got in both(x, min_kk):
        assert np.array_equal(got, want)
    if rows == "runs" and min_kk <= 2 * W:
        assert np.array_equal(want, np.sort(x, axis=1))
    if min_kk > L:
        assert np.array_equal(want, x)


def numpy_network(x, min_kk):
    """The stage loop over ``binary_spgemm_tpu.ops.bitonic._stages``,
    transcribed in numpy with explicit partner indices (no rolls)."""
    x = x.copy()
    L = x.shape[1]
    i = np.arange(L)
    for kk, j in jx_bitonic._stages(L):
        if kk < min_kk:
            continue
        partner = x[:, i ^ j]
        take_min = ((i & j) == 0) == ((i & kk) == 0)
        x = np.where(take_min, np.minimum(x, partner), np.maximum(x, partner))
    return x


@pytest.mark.parametrize("min_kk", [2, 4, 32, 4096, 8192])
@pytest.mark.parametrize("rows", ["random", "runs"])
def test_network_at_4096_matches_a_numpy_transcription(min_kk, rows):
    x = random_rows(8, 4096, min_kk)
    if rows == "runs":
        x = runs_rows(x, W)
    want = numpy_network(x, min_kk)
    for got in both(x, min_kk):
        assert np.array_equal(got, want)
    if rows == "runs" and min_kk <= 2 * W:
        assert np.array_equal(want, np.sort(x, axis=1))
    elif rows == "random" and 2 < min_kk <= 4096:
        assert not np.array_equal(want, np.sort(x, axis=1))  # only partly sorted


@pytest.mark.parametrize("L", [32, 256, 4096])
def test_alternating_runs_is_the_reference_precondition(L):
    x = random_rows(6, L, L)
    assert np.array_equal(alternating_runs(torch.from_numpy(x), W).numpy(),
                          runs_rows(x, W))


@pytest.mark.parametrize("L", [1, 2, 4, 64, 128, 4096, 32768])
def test_stages_and_blocks_are_the_reference_helpers(L):
    assert bitonic._stages(L) == jx_bitonic._stages(L)
    for k in (8, 24, 96, 128, 640, 7):
        assert bitonic._pick_block(k, L) == jx_bitonic._pick_block(k, L)


@pytest.mark.parametrize("L", [1, 2, 256, 4096, 32768])
def test_first_merge_is_the_first_stage_run(L):
    for min_kk in (-3, 0, 1, 2, 3, 4, 5, 31, 32, 33, L - 1, L, L + 1, 2 * L, 1 << 40):
        log_kk0 = bitonic._first_merge(min_kk, L)
        run = [kk for kk, _ in bitonic._stages(L) if kk >= min_kk]
        if run:
            assert 1 << log_kk0 == run[0], (min_kk, log_kk0)
        else:
            assert 1 << log_kk0 > L and 1 <= log_kk0 <= 16, (min_kk, log_kk0)


@pytest.mark.parametrize("k", [1, 5, 13])
def test_any_row_count(k):
    x = random_rows(max(k, 3), 256, k)[:k]
    for got in both(x, 2):
        assert np.array_equal(got, np.sort(x, axis=1))


def test_no_stage_is_a_copy():
    xt = torch.from_numpy(random_rows(4, 64, 1))
    for f in (bitonic.bitonic_network_rows, bitonic.bitonic_network_rows_plain):
        got = f(xt, 128)
        assert torch.equal(got, xt) and got.data_ptr() != xt.data_ptr()


def test_cpu_tensors_launch_nothing():
    bitonic.bitonic_network_rows.launches = 0
    bitonic.bitonic_sort_rows.launches = 0
    bitonic.bitonic_network_rows(torch.from_numpy(random_rows(4, 256, 2)), 32)
    assert bitonic.bitonic_network_rows.launches == 0
    assert bitonic.bitonic_sort_rows.launches == 0


@pytest.mark.parametrize(
    "bad,match",
    [
        (torch.zeros((4, 8), dtype=torch.int64), "int32"),
        (torch.zeros(8, dtype=torch.int32), "2-D"),
        (torch.zeros((8, 4), dtype=torch.int32).t(), "contiguous"),
        (torch.zeros((4, 3), dtype=torch.int32), "power of two"),
        (torch.zeros((4, 1000), dtype=torch.int32), "power of two"),
        (torch.zeros((4, 0), dtype=torch.int32), "power of two"),
        (torch.zeros((1, 2 * bitonic.MAX_L), dtype=torch.int32), "shared-memory"),
    ],
)
def test_wrapper_raises_on_what_the_kernels_do_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        bitonic.bitonic_network_rows(bad, 2)
