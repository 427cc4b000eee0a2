"""The row-partitioned distributed layer on ``torch.distributed``.

Counterpart of ``binary_spgemm_tpu/parallel/``: one process (rank) per
shard in place of ``shard_map`` over a device mesh.  :mod:`.mesh` holds the
row partition and the rank's view of the group, :mod:`.comm` every
collective, :mod:`.launch` the spawner of a local group, :mod:`.dist_spgemm`
the products, the op family, the counting family
(``dist_spgemm_counts``, ``dist_masked_spgemm_counts``) and
``dist_triangle_count``, :mod:`.dist_onesort` the one-sort
``dist_transitive_closure`` and ``dist_k_hop``, :mod:`.multihost` the
sharded-ingest glue, :mod:`.scaling` the scaling report, and
:mod:`.dryrun` the 19 paths the JAX package's dryrun certifies.
"""
