"""Parallelism of the port: the device mesh over ``torch.distributed``
ranks (``mesh``), timeline-sharded interpolation (``sequence``), the
multi-rank dry run (``dryrun``) and the ``--shard`` process proofs
(``shardproof``)."""

from iv_interpolation_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    surface_batch_sharding,
)
