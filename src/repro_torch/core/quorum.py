"""Port of `repro/core/quorum.py` (copied).

Quorum arithmetic and the proxy-side commit check (paper S6.3-S6.4, Alg 2).

fast quorum  = 1 + f + ceil(f/2)   (super quorum, incl. the leader)
slow quorum  = 1 + f               (leader fast-reply + f follower slow-replies)

A slow-reply subsumes the same follower's fast-reply for the *fast* quorum
(it proves log consistency with the leader), but not vice versa.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional


def fast_quorum_size(f: int) -> int:
    return 1 + f + math.ceil(f / 2)


def slow_quorum_size(f: int) -> int:
    return 1 + f


def n_replicas(f: int) -> int:
    return 2 * f + 1


def leader_of_view(view_id: int, f: int) -> int:
    return view_id % (2 * f + 1)


@dataclass
class QuorumTracker:
    """Per-request reply aggregation at a proxy/client (Algorithm 2).

    Collects fast/slow replies; `check_committed` returns the leader's reply
    once either quorum is established. Replies from old views are purged when
    a newer view appears (Alg 2 lines 8-9).
    """

    f: int
    view_id: int = -1
    fast_hashes: dict[int, int] = field(default_factory=dict)   # replica -> hash
    fast_results: dict[int, object] = field(default_factory=dict)
    slow_replicas: set[int] = field(default_factory=set)
    committed: bool = False
    fast_path: Optional[bool] = None

    def add_fast(self, replica_id: int, view_id: int, hash_: int, result: object) -> None:
        self._maybe_reset(view_id)
        if view_id < self.view_id:
            return  # stale view
        self.fast_hashes[replica_id] = hash_
        # store unconditionally: a leader's legitimate result may be None
        # (e.g. GET of a missing key); followers' None results are unused.
        self.fast_results[replica_id] = result

    def add_slow(self, replica_id: int, view_id: int) -> None:
        self._maybe_reset(view_id)
        if view_id < self.view_id:
            return
        self.slow_replicas.add(replica_id)

    def _maybe_reset(self, view_id: int) -> None:
        if view_id > self.view_id:
            self.view_id = view_id
            self.fast_hashes.clear()
            self.fast_results.clear()
            self.slow_replicas.clear()

    def check_committed(self) -> Optional[object]:
        """Returns the leader's result if committed (fast or slow), else None."""
        leader = leader_of_view(self.view_id, self.f)
        if leader not in self.fast_hashes:
            return None  # leader's fast-reply is mandatory (it has the result)
        leader_hash = self.fast_hashes[leader]
        # Fast path: replies matching the leader's hash + slow-replies.
        fast_n = 0
        for rid in range(n_replicas(self.f)):
            if rid in self.slow_replicas:
                fast_n += 1  # slow-reply subsumes fast-reply
            elif rid in self.fast_hashes and self.fast_hashes[rid] == leader_hash:
                fast_n += 1
        if fast_n >= fast_quorum_size(self.f):
            self.committed, self.fast_path = True, True
            return self.fast_results.get(leader, True)
        # Slow path: leader fast-reply + f follower slow-replies.
        slow_n = 1 + len(self.slow_replicas - {leader})
        if slow_n >= slow_quorum_size(self.f):
            self.committed, self.fast_path = True, False
            return self.fast_results.get(leader, True)
        return None


__all__ = [
    "fast_quorum_size",
    "slow_quorum_size",
    "n_replicas",
    "leader_of_view",
    "QuorumTracker",
]
