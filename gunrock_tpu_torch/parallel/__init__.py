"""The sharded primitives on a shard mesh of one device.

Counterpart of :mod:`gunrock_tpu.parallel`, with its public names: the
mesh, partitioning, the boundary exchange, the ten sharded primitives
and the replicated batches. See ``mesh.py`` for how the JAX package's
``shard_map`` over a device mesh maps onto stacked tensors on one card.
"""

from .mesh import make_mesh, AXIS  # noqa: F401
from .partition import PartitionedGraph, partition, make_permutation  # noqa: F401
from .comm import bucket_by_owner, exchange, recv_mask  # noqa: F401
from .bfs import bfs_sharded, bfs_sharded_device, ShardedBfsResult  # noqa: F401
from .pr import pagerank_sharded, pagerank_sharded_device, ShardedPrResult  # noqa: F401
from .hits import hits_sharded, salsa_sharded, ShardedLinkResult  # noqa: F401
from .wtf import wtf_sharded, ShardedWtfResult  # noqa: F401
from .topk import topk_sharded, ShardedTopkResult  # noqa: F401
from .tc import tc_sharded, ShardedTcResult  # noqa: F401
from .sssp import sssp_sharded, sssp_sharded_device, ShardedSsspResult  # noqa: F401
from .cc import cc_sharded, cc_sharded_device, ShardedCcResult  # noqa: F401
from .bc import bc_sharded, bc_sharded_device, ShardedBcResult  # noqa: F401
from .comm import ghost_exchange  # noqa: F401
from .replicate import (bc_batch, bfs_batch,  # noqa: F401
                        BatchBcResult, BatchBfsResult)
from .partition import boundary_fraction, label_propagation  # noqa: F401
