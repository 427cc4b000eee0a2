"""binary_spgemm_tpu_torch — boolean SpGEMM in PyTorch with CUDA kernels.

A port of ``binary_spgemm_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100: the sparsity structure of C = A·B over boolean CSR matrices,
bit-exact against scipy.  This package imports neither JAX nor the JAX
package.  Ported so far:

* the batched sliced-ELL engine end to end (``auto_executor`` /
  ``EllSpGEMMExecutor(batched=True)`` / ``spgemm``), with its row sorts as a
  hand-written CUDA bitonic kernel (``ops/bitonic.py``, ``csrc/bitonic.cu``);
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
from .ops.ell import EllSpGEMMExecutor, auto_executor
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
    "spgemm",
    "spgemm_flops",
]

__version__ = "0.1.0"
