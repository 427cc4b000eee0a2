"""The port's CUDA kernels and its main path on a card.  Every test here is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor the JAX package, so it runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import bitonic
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

pytestmark = pytest.mark.cuda

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "k,L", [(1024, 3968), (512, 4096), (333, 37), (16, bitonic.MAX_L), (7, 1)]
)
def test_kernels_equal_their_plain_versions(cuda_device, k, L):
    rng = np.random.default_rng(k + L)
    x = rng.integers(0, max(L // 2, 2), (k, L)).astype(np.int32)
    x[0, : min(3, L)] = I32_MAX
    x[-1, : min(2, L)] = I32_MIN
    xt = torch.from_numpy(x).to(cuda_device)
    limit = max(L // 3, 1)
    n1, n2 = bitonic.bitonic_sort_rows.launches, bitonic.fused_sort_compress.launches
    got1 = bitonic.bitonic_sort_rows(xt)
    got2 = bitonic.fused_sort_compress(xt, limit)
    torch.cuda.synchronize()
    assert torch.equal(got1, bitonic.bitonic_sort_rows_plain(xt))
    assert torch.equal(got2, bitonic.fused_sort_compress_plain(xt, limit))
    assert bitonic.bitonic_sort_rows.launches == n1 + 1
    assert bitonic.fused_sort_compress.launches == n2 + 1


def test_kernels_raise_past_shared_memory(cuda_device):
    x = torch.zeros((1, bitonic.MAX_L + 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared-memory"):
        bitonic.bitonic_sort_rows(x)


def test_batched_executor_on_the_card(cuda_device):
    a = tp.BCSR.random(1 << 16, 1 << 16, 2.0, seed=31)
    ex = tp.auto_executor(a, a)
    assert ex.er_all.device.type == "cuda"
    n1 = bitonic.bitonic_sort_rows.launches
    out = ex.run()
    torch.cuda.synchronize()
    assert bitonic.bitonic_sort_rows.launches == n1 + 2 * ex.n_groups
    assert ex.assemble(out).equals(spgemm_oracle(a, a))
