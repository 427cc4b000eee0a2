"""binary_spgemm_tpu_torch — boolean SpGEMM in PyTorch with CUDA kernels.

A port of ``binary_spgemm_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100: the sparsity structure of C = A·B over boolean CSR matrices,
bit-exact against scipy.  This package imports neither JAX nor the JAX
package.  Ported so far:

* the sliced-ELL engine end to end in both plans (``auto_executor`` /
  ``EllSpGEMMExecutor`` / ``ell_spgemm`` / ``spgemm``): batched bins for many
  rows, unrolled contiguous or dealt chunks below 2^16 rows and for skewed
  products.  Its row sorts are a hand-written CUDA bitonic kernel
  (``ops/bitonic.py``, ``csrc/bitonic.cu``) up to 32,768 slots a row and
  ``torch.sort`` past that; its class-table row gathers are hand-written
  CUDA kernels (``ops/gather.py``, ``csrc/gather.cu``);
* the host engine for small products (``host_spgemm``, behind ``spgemm``);
* the blocked tensor-core route for block-clustered operands
  (``BlockedBCSR``, ``bsr_spgemm``, and ``BsrStagedExecutor`` behind
  ``auto_executor`` / ``spgemm``), with its grouped tile products as a
  hand-written CUDA kernel (``ops/block_matmul.py``,
  ``csrc/block_matmul.cu``).

Entry points run on ``device="cuda"`` unless told otherwise; routes of the
JAX package not ported yet raise ``NotImplementedError`` naming the ROADMAP
item that will port them.
"""
from .formats.bbcsr import BlockedBCSR, blocked_from_arrays
from .formats.bcsr import BCSR, bcsr_from_arrays, coo_to_csr_stable
from .ops.bsr import bsr_spgemm
from .ops.ell import EllSpGEMMExecutor, auto_executor, ell_spgemm
from .ops.host import host_spgemm
from .ops.spgemm import spgemm, spgemm_flops

__all__ = [
    "BCSR",
    "BlockedBCSR",
    "EllSpGEMMExecutor",
    "auto_executor",
    "bcsr_from_arrays",
    "blocked_from_arrays",
    "bsr_spgemm",
    "coo_to_csr_stable",
    "ell_spgemm",
    "host_spgemm",
    "spgemm",
    "spgemm_flops",
]

__version__ = "0.1.0"
