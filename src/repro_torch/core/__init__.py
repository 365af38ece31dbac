"""Port of `repro/core`: DOM and the Nezha consensus protocol.

The exact event-driven implementation (replica, proxy, protocol) and the
eight baselines run on the host; the vectorized Nezha data plane runs on
torch (the card by default), and the sharded backend runs G such groups
over one key space. Every backend implements `Cluster`; construct any of
them with `make_cluster(name, config)` and drive them with
`repro_torch.sim.workload.WorkloadDriver`.
"""
from repro_torch.core.clock import Clock, ClockParams, SyncService
from repro_torch.core.cluster import (
    SUMMARY_REQUIRED_KEYS,
    Cluster,
    CommonConfig,
    summarize_commits,
)
from repro_torch.core.dom import (
    DomParams,
    DomReceiver,
    DomSender,
    EarlyBuffer,
    LateBuffer,
    OwdEstimator,
)
from repro_torch.core.engine import DomEngine, PendingBuffer
from repro_torch.core.hashing import IncrementalHash, PerKeyHashTable
from repro_torch.core.messages import OpType, Request, Status
from repro_torch.core.protocol import ClusterConfig, NezhaCluster
from repro_torch.core.quorum import (
    QuorumTracker,
    fast_quorum_size,
    leader_of_view,
    slow_quorum_size,
)
from repro_torch.core.registry import (
    available_clusters,
    config_class,
    make_cluster,
)
from repro_torch.core.replica import (
    KVStore,
    NullApp,
    Replica,
    ReplicaParams,
    StateMachine,
)
from repro_torch.core.sharded import (
    ShardedConfig,
    ShardedNezhaCluster,
    make_sharded,
)
from repro_torch.core.vectorized_cluster import (
    VectorizedConfig,
    VectorizedNezhaCluster,
    config_from_reference,
)

__all__ = ["Clock", "ClockParams", "SyncService",
           "SUMMARY_REQUIRED_KEYS", "Cluster", "CommonConfig",
           "summarize_commits",
           "DomParams", "DomReceiver", "DomSender", "EarlyBuffer",
           "LateBuffer", "OwdEstimator", "DomEngine", "PendingBuffer",
           "IncrementalHash", "PerKeyHashTable",
           "OpType", "Request", "Status",
           "ClusterConfig", "NezhaCluster",
           "VectorizedConfig", "VectorizedNezhaCluster",
           "ShardedConfig", "ShardedNezhaCluster", "make_sharded",
           "config_from_reference",
           "make_cluster", "available_clusters", "config_class",
           "QuorumTracker", "fast_quorum_size", "slow_quorum_size",
           "leader_of_view",
           "KVStore", "NullApp", "Replica", "ReplicaParams", "StateMachine"]
