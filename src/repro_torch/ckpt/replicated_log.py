"""Port of `repro/ckpt/replicated_log.py` (copied): the Nezha-replicated
training-metadata log, on the host.

The coordination plane of a 1000-node training job -- checkpoint commits,
elastic-scaling events, data-shard leases -- is a replicated state machine.
This wraps a NezhaCluster (f=1 by default) around a KVStore and exposes the
operations the trainer needs. The simulated cluster advances its event loop
inside `_run()`; on a real deployment the same client API fronts the Nezha
proxy fleet.

This is the paper's "drop-in Raft/Multi-Paxos replacement" story applied to
an ML system's control plane: the log commits in 1 wide-area RTT on the
fast path instead of 2, and the proxy fleet absorbs the quorum fan-out.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.core.messages import OpType
from repro_torch.core.protocol import ClusterConfig
from repro_torch.core.registry import make_cluster
from repro_torch.core.replica import KVStore


class ReplicatedMetadataLog:
    def __init__(self, f: int = 1, seed: int = 0):
        cfg = ClusterConfig(f=f, n_proxies=1, n_clients=1, seed=seed)
        self.cluster = make_cluster("nezha", cfg, sm_factory=KVStore)
        self.cluster.start()
        self._completed: dict[int, object] = {}
        self.cluster.on_commit = self._on_commit

    def _on_commit(self, cid, rid):
        self._completed[rid] = self.cluster.result_of(cid, rid)

    def _run(self, op, keys, command) -> object:
        _, rid = self.cluster.submit(0, command=command, op=op, keys=keys)
        # drive the simulated cluster until this request commits
        for _ in range(200):
            self.cluster.run_for(5e-3)
            if rid in self._completed:
                return self._completed.pop(rid)
        raise TimeoutError("metadata log did not commit in time")

    # -- trainer-facing API ---------------------------------------------------
    def commit_manifest(self, step: int, integrity_hash: int, path: str) -> None:
        rec = json.dumps({"step": step, "hash": integrity_hash, "path": path})
        self._run(OpType.WRITE, ("ckpt-latest",), ("SET", "ckpt-latest", rec))
        self._run(OpType.WRITE, (f"ckpt-{step}",), ("SET", f"ckpt-{step}", rec))

    def latest_committed(self) -> Optional[dict]:
        rec = self._run(OpType.READ, ("ckpt-latest",), ("GET", "ckpt-latest"))
        return json.loads(rec) if rec else None

    def record_scaling_event(self, step: int, n_healthy: int, mesh_shape) -> None:
        rec = json.dumps({"step": step, "n_healthy": n_healthy,
                          "mesh": list(mesh_shape)})
        self._run(OpType.WRITE, ("scaling",), ("SET", "scaling", rec))

    def current_scaling(self) -> Optional[dict]:
        rec = self._run(OpType.READ, ("scaling",), ("GET", "scaling"))
        return json.loads(rec) if rec else None

    def acquire_shard_lease(self, shard: int, host: str) -> bool:
        key = f"lease-{shard}"
        cur = self._run(OpType.READ, (key,), ("GET", key))
        if cur and cur != host:
            return False
        self._run(OpType.WRITE, (key,), ("SET", key, host))
        return True

    @property
    def fast_commit_ratio(self) -> float:
        return self.cluster.summary()["fast_commit_ratio"]


__all__ = ["ReplicatedMetadataLog"]
