"""Port of `repro/core`: the vectorized Nezha data plane on torch, and the
sharded backend of G such groups over one key space."""
from repro_torch.core.cluster import (
    SUMMARY_REQUIRED_KEYS,
    Cluster,
    CommonConfig,
    summarize_commits,
)
from repro_torch.core.hashing import IncrementalHash, PerKeyHashTable
from repro_torch.core.registry import (
    available_clusters,
    config_class,
    make_cluster,
)
from repro_torch.core.sharded import ShardedConfig, ShardedNezhaCluster
from repro_torch.core.vectorized_cluster import (
    VectorizedConfig,
    VectorizedNezhaCluster,
    config_from_reference,
)

__all__ = ["SUMMARY_REQUIRED_KEYS", "Cluster", "CommonConfig",
           "summarize_commits", "available_clusters", "config_class",
           "make_cluster",
           "VectorizedConfig", "VectorizedNezhaCluster",
           "ShardedConfig", "ShardedNezhaCluster",
           "config_from_reference", "IncrementalHash", "PerKeyHashTable"]
