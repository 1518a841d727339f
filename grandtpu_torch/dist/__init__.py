"""Distribution layer, on one process or across ``torch.distributed``
ranks: the device mesh and its differentiable collectives, data-parallel
placement of the training step (D2) with its tensor-parallel form on the
mesh's 'model' axis, row-partitioned full-graph propagation (D1, the
all_gather and the halo-exchange variants), and the source-sharded pushes
(over a mesh, and over processes)."""

from grandtpu_torch.dist.mesh import Mesh, make_mesh  # noqa: F401
from grandtpu_torch.dist.data_parallel import (  # noqa: F401
    joined_state, shard_batch, shard_sparse_train_inputs, shard_train_inputs,
)
from grandtpu_torch.dist.spmm_shard import (  # noqa: F401
    BlockShardedGraph, BlockShardedPropagator, ShardedGraph,
    ShardedPropagator, default_halo_threshold, dist_exact_propagate,
    dist_exact_propagator, sharded_propagate,
)
from grandtpu_torch.dist.halo import (  # noqa: F401
    HaloPropagator, HaloShardedGraph, estimate_halo_compression,
)
from grandtpu_torch.dist.push import (  # noqa: F401
    multihost_native_gfpush, push_source_shard, sharded_gfpush,
)
