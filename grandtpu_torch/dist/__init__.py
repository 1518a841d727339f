"""Distribution layer: the device mesh and row-partitioned full-graph
propagation (D1), the all_gather and the halo-exchange variants, on the
port's single-process mesh. Data-parallel training and the sharded push
(grandtpu's ``data_parallel`` and ``push``, D2) are not ported yet."""

from grandtpu_torch.dist.mesh import Mesh, make_mesh  # noqa: F401
from grandtpu_torch.dist.spmm_shard import (  # noqa: F401
    BlockShardedGraph, BlockShardedPropagator, ShardedGraph,
    ShardedPropagator, dist_exact_propagate, dist_exact_propagator,
    sharded_propagate,
)
from grandtpu_torch.dist.halo import (  # noqa: F401
    HaloPropagator, HaloShardedGraph, estimate_halo_compression,
)
