"""The row-partitioned distributed layer on ``torch.distributed``.

Counterpart of ``binary_spgemm_tpu/parallel/``: one process (rank) per
shard in place of ``shard_map`` over a device mesh.  :mod:`.mesh` holds the
row partition and the rank's view of the group, :mod:`.comm` every
collective, :mod:`.launch` the spawner of a local group, :mod:`.dist_spgemm`
the products and the op family, :mod:`.multihost` the sharded-ingest glue,
and :mod:`.dryrun` the paths the JAX package's dryrun certifies.
"""
