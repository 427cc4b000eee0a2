"""binary_spgemm_tpu_torch — boolean SpGEMM in PyTorch with CUDA kernels.

A port of ``binary_spgemm_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100: the sparsity structure of C = A·B over boolean CSR matrices,
bit-exact against scipy.  This package imports neither JAX nor the JAX
package.  It does everything the JAX package does:

* the sliced-ELL engine end to end in both plans (``auto_executor`` /
  ``EllSpGEMMExecutor`` / ``ell_spgemm`` / ``spgemm``): batched bins for many
  rows, unrolled contiguous or dealt chunks below 2^16 rows and for skewed
  products.  Its row sorts are a hand-written CUDA bitonic kernel
  (``ops/bitonic.py``, ``csrc/bitonic.cu``) up to 32,768 slots a row and
  ``torch.sort`` past that; its class-table row gathers are hand-written
  CUDA kernels (``ops/gather.py``, ``csrc/gather.cu``);
* ``tuned_executor``: the batched plan's bin count picked by timing the
  model's best candidates between CUDA events on the card;
* the chunked expand–sort–compress (ESC) engine (``SpGEMMExecutor``, and
  behind ``spgemm`` / ``auto_executor`` for an explicit ``chunk_flops``,
  products past the resident ELL budget and products every ELL plan
  overflows), in torch ops with one-key ``torch.sort`` calls (an int64
  ``(row << 32) | col`` key where the pair does not pack into int32);
* the column-windowed route for rows past ``GIANT_ROW_FLOPS`` flops, behind
  ``spgemm``;
* the host engine for small products (``host_spgemm``, behind ``spgemm``,
  and its masked, union and fused-OR forms behind the op family);
* the op family on every engine: ``masked_spgemm`` (C = F .* (A·B)),
  ``spm_or`` (A OR B) and ``spgemm_or`` (D OR (A·B), optionally masked),
  with the executors' ``run_masked`` / ``run_or`` (``masked=True`` plans,
  ``cached_executor(masked=)``, ``tuned_executor(masked=True)``) and the
  one-sort ``run_padded`` / ``assemble_padded``;
* the counting family on every engine: ``spgemm_counts`` (C = A·B with
  each entry's multiplicity, the integer product of the 0/1 operands),
  ``masked_spgemm_counts`` (the same over a mask's support) and
  ``ops.counts.triangle_count_device``, with the executors' ``run_counts``
  / ``run_masked_counts`` / ``run_counts_sum`` and ``assemble_counts``;
* Matrix-Market ingest and egest (``read_pattern``, ``write_pattern``,
  ``write_integer``) and the whole ``BCSR`` container
  (``from_torch`` / ``to_torch``, ``transpose``, ``sort_indices``,
  ``diff``, ``flops``);
* the blocked tensor-core route for block-clustered operands
  (``BlockedBCSR``, ``bsr_spgemm``, and ``BsrStagedExecutor`` behind
  ``auto_executor`` / ``spgemm``), with its grouped tile products as a
  hand-written CUDA kernel (``ops/block_matmul.py``,
  ``csrc/block_matmul.cu``);
* the device-resident pipelines: ``DeviceBCSR`` and the ops of
  ``ops/device_api.py`` on it, and the one-sort streams with holes
  (``PaddedDeviceBCSR``, ``spgemm_onesort_device``,
  ``spgemm_or_onesort_device``);
* the graph ops (``ops/graph.py``): ``k_hop`` and ``transitive_closure``
  (host, resident compacted and resident one-sort routes), ``bfs_levels``,
  ``reachable``, ``triangle_structure``, ``triangle_count``,
  ``clustering_coefficients`` and ``k_truss``;
* the row-partitioned distributed layer on ``torch.distributed``
  (``parallel/``): ``dist_spgemm`` over every B layout and engine, the
  masked, fused-OR and union ops, the counting family
  (``dist_spgemm_counts``, ``dist_masked_spgemm_counts``) and
  ``dist_triangle_count``, the one-sort ``dist_transitive_closure`` and
  ``dist_k_hop`` (``parallel/dist_onesort.py``), the sharded ingest
  (``multihost.dist_spgemm_from_local``), ``launch`` for a local group,
  and the scaling report (``parallel/scaling.py``);
* the native host tier (``native/``: the port's own ``mmparse.c``, built
  with ``cc`` at first use): the Matrix-Market parser and writer, the
  COO->CSR grouping, the sliced-ELL class partition and table fill,
  ``row_flops`` and the host engine's products;
* the CLI's ``bench``, ``gen``, ``multiply``, ``graph`` and ``validate``
  commands (``python -m binary_spgemm_tpu_torch.cli``).

Entry points run on ``device="cuda"`` unless told otherwise; ``device=`` is
always the torch device.  The JAX package's boolean ``device=`` flag of
``k_hop``, ``transitive_closure`` and ``triangle_count`` (keep the matrices
on the accelerator) is ``resident=`` here, with the same defaults.
"""
from .formats.bbcsr import BlockedBCSR, blocked_from_arrays
from .formats.bcsr import BCSR, bcsr_from_arrays, coo_to_csr_stable
from .io.mmio import read_pattern, write_integer, write_pattern
from .ops.bsr import bsr_spgemm
from .ops.counts import masked_spgemm_counts, spgemm_counts
from .ops.ell import EllSpGEMMExecutor, auto_executor, ell_spgemm, tuned_executor
from .ops.fused import spgemm_or
from .ops.graph import (
    bfs_levels,
    clustering_coefficients,
    k_hop,
    k_truss,
    reachable,
    transitive_closure,
    triangle_count,
    triangle_structure,
)
from .ops.host import (
    host_masked_spgemm,
    host_spgemm,
    host_spgemm_counts,
    host_spgemm_or,
    host_spm_or,
)
from .ops.masked import masked_spgemm
from .ops.onesort import (
    PaddedDeviceBCSR,
    spgemm_onesort_device,
    spgemm_or_onesort_device,
)
from .ops.spgemm import DeviceBCSR, SpGEMMExecutor, spgemm, spgemm_flops
from .ops.union import spm_or

__all__ = [
    "BCSR",
    "BlockedBCSR",
    "DeviceBCSR",
    "EllSpGEMMExecutor",
    "PaddedDeviceBCSR",
    "SpGEMMExecutor",
    "auto_executor",
    "bcsr_from_arrays",
    "bfs_levels",
    "blocked_from_arrays",
    "bsr_spgemm",
    "clustering_coefficients",
    "coo_to_csr_stable",
    "ell_spgemm",
    "host_masked_spgemm",
    "host_spgemm",
    "host_spgemm_counts",
    "host_spgemm_or",
    "host_spm_or",
    "k_hop",
    "k_truss",
    "masked_spgemm",
    "masked_spgemm_counts",
    "reachable",
    "read_pattern",
    "spgemm",
    "spgemm_counts",
    "spgemm_flops",
    "spgemm_onesort_device",
    "spgemm_or",
    "spgemm_or_onesort_device",
    "spm_or",
    "transitive_closure",
    "triangle_count",
    "triangle_structure",
    "tuned_executor",
    "write_integer",
    "write_pattern",
]

__version__ = "0.1.0"
