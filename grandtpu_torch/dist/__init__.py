"""Distribution layer, on the port's single-process mesh: the device mesh
and its differentiable collectives, data-parallel placement of the
training step (D2), row-partitioned full-graph propagation (D1, the
all_gather and the halo-exchange variants), and the source-sharded push.
Meshes over processes and tensor parallelism are ROADMAP Queue A 8."""

from grandtpu_torch.dist.mesh import Mesh, make_mesh  # noqa: F401
from grandtpu_torch.dist.data_parallel import (  # noqa: F401
    shard_batch, shard_sparse_train_inputs, shard_train_inputs,
)
from grandtpu_torch.dist.spmm_shard import (  # noqa: F401
    BlockShardedGraph, BlockShardedPropagator, ShardedGraph,
    ShardedPropagator, dist_exact_propagate, dist_exact_propagator,
    sharded_propagate,
)
from grandtpu_torch.dist.halo import (  # noqa: F401
    HaloPropagator, HaloShardedGraph, estimate_halo_compression,
)
from grandtpu_torch.dist.push import (  # noqa: F401
    push_source_shard, sharded_gfpush,
)
