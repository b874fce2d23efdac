"""patch2pix_tpu_torch.parallel: the mesh over ``torch.distributed``
(``mesh.py``), the collective accounting (``comm_stats.py``) and the
h1-sharded coarse volume (``volume_sharding.py``); the JAX package's
names and more."""

from patch2pix_tpu_torch.parallel.comm_stats import format_comm_table, record_collectives
from patch2pix_tpu_torch.parallel.mesh import (
    Mesh,
    data_sharding,
    initialize_multihost,
    make_mesh,
    process_group,
    replicated,
    shard_batch,
)
from patch2pix_tpu_torch.parallel.volume_sharding import make_sharded_coarse_matcher

__all__ = [
    "data_sharding",
    "initialize_multihost",
    "make_mesh",
    "replicated",
    "shard_batch",
    "Mesh",
    "process_group",
    "format_comm_table",
    "record_collectives",
    "make_sharded_coarse_matcher",
]
