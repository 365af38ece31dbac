"""Port of `repro/core`: the vectorized Nezha data plane on torch."""
from repro_torch.core.cluster import (
    SUMMARY_REQUIRED_KEYS,
    Cluster,
    CommonConfig,
    summarize_commits,
)
from repro_torch.core.registry import available_clusters, make_cluster
from repro_torch.core.vectorized_cluster import (
    VectorizedConfig,
    VectorizedNezhaCluster,
    config_from_reference,
)

__all__ = ["SUMMARY_REQUIRED_KEYS", "Cluster", "CommonConfig",
           "summarize_commits", "available_clusters", "make_cluster",
           "VectorizedConfig", "VectorizedNezhaCluster",
           "config_from_reference"]
