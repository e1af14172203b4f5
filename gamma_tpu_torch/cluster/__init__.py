"""Multi-host (partition) tier: router + partition engine servers.

Reference architecture: Vearch shards a corpus into partitions above the
gamma C ABI (3 masters + routers + N partition servers; vearch's ps/ and
router/ Go services, see reference benchs/README.md topology).  The gamma
repo itself contributes the per-partition engine plus the migration hooks
(c_api/gamma_api.h:194-206).  Here the same composition is implemented
over the in-repo socket protocol (gamma_tpu_torch/server.py): each partition
server is a `serve()` process that owns one engine (one TPU host), and
`GammaRouter` hash-partitions documents and scatter-gathers searches.

Design doc: docs/MULTIHOST.md (tier 2).  No cross-host collective is
needed on the query path — per-partition top-k merge is a host-side
k-way merge.
"""

from gamma_tpu_torch.cluster.router import GammaRouter, PartitionSpec
from gamma_tpu_torch.cluster.partition import launch_local, LocalCluster

__all__ = ["GammaRouter", "PartitionSpec", "launch_local", "LocalCluster"]
