"""Port of `repro/core/baselines.py` (copied).

Baseline consensus protocols the paper compares against (S9).

Event-driven implementations over the same SimFabric (network + per-node CPU
accounting) as Nezha, so Fig 8-style latency/throughput comparisons are
apples-to-apples:

* MultiPaxos     -- 4 message delays, leader-centric, load 2(2f+1) (Table 1).
* Raft           -- Multi-Paxos shape + optional per-batch disk fsync (S9.10).
* FastPaxos      -- client multicast, leader quorum-check; arrival-order slots
                    so cloud reordering forces the 5-delay slow path (S9.2).
* NOPaxos        -- software sequencer; sequential gap handling blocks the
                    replica (the paper's observed open-loop collapse).
* NOPaxosOptim   -- the paper's optimized variant: gap handling off the
                    critical path (separate thread).
* Domino (DFP)   -- clock-deadline fast paxos, commit/execute decoupled;
                    commit latency reported (S9.3).
* TOQEPaxos      -- EPaxos with TOQ-reduced conflicts; commit latency
                    reported; execution adds the paper's 1.3-3.3ms lag.

Unreplicated    -- client -> server -> client; the S10 application baseline.

Every cluster implements the unified `repro_torch.core.cluster.Cluster` API
(submit/submit_at/run_for/on_commit/summary); construct them through
`repro_torch.core.registry.make_cluster`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.clock import Clock
from repro_torch.core.cluster import CommonConfig, EventCluster, summarize_commits
from repro_torch.core.dom import DomParams, OwdEstimator
from repro_torch.core.messages import OpType
from repro_torch.core.quorum import fast_quorum_size, n_replicas
from repro_torch.sim.transport import CpuParams, SimFabric


@dataclass
class BaselineConfig(CommonConfig):
    """Baseline-specific extension of the shared `CommonConfig` core."""

    # The upstream baseline implementations (NOPaxos repo) run the protocol
    # core on ONE thread; per-message costs calibrated so Multi-Paxos
    # saturates ~75-100K req/s as in Fig 8 (see EXPERIMENTS.md §Calibration).
    replica_cpu: CpuParams = field(
        default_factory=lambda: CpuParams(send_cost=0.9e-6, recv_cost=2.2e-6, threads=1.0))
    # The paper's software sequencer is explicitly multithreaded (S9.1).
    sequencer_cpu: CpuParams = field(
        default_factory=lambda: CpuParams(send_cost=0.45e-6, recv_cost=1.05e-6, threads=4.0))
    client_timeout: float = 25e-3
    disk_write_latency: float = 0.0     # per-fsync (Raft / Nezha-disk, S9.10)
    disk_batch: int = 64


@dataclass
class Rec:
    submit_time: float
    commit_time: float = float("nan")
    fast_path: bool = False
    retries: int = 0
    extra: float = 0.0   # e.g. execution lag for decoupled protocols


class _Base(EventCluster):
    """Shared scaffolding: fabric, clients, records, retries, summary.

    Implements the unified `Cluster` API. Baselines do not model replica
    failures, so `crash`/`relaunch` keep the base-class NotImplementedError.
    """

    name = "base"

    @property
    def protocol(self) -> str:
        return self.name

    def __init__(self, cfg: BaselineConfig, n_extra_nodes: int = 0):
        self.cfg = cfg
        self.f = cfg.f
        self.n = n_replicas(cfg.f)
        total = self.n + n_extra_nodes + cfg.n_clients
        self.fabric = SimFabric(total, cfg.net, seed=cfg.seed)
        self.scheduler = self.fabric.scheduler
        for i in range(self.n):
            self.fabric.set_cpu(i, cfg.replica_cpu)
        for c in range(cfg.n_clients):
            self.fabric.set_cpu(self.n + n_extra_nodes + c, cfg.client_cpu)
        self._extra_base = self.n
        self._client_base = self.n + n_extra_nodes
        self.records: dict[tuple[int, int], Rec] = {}
        self._next_rid = [0] * cfg.n_clients
        self.on_commit = None

    def client_node(self, cid: int) -> int:
        return self._client_base + cid

    def submit(self, client_id: int = 0, request_id: Optional[int] = None,
               keys: tuple = (), op=None, command=None) -> tuple[int, int]:
        """Unified-API submission: ``keys[0]`` is the (single) conflict key;
        ``op == OpType.READ`` marks read-only requests. ``command`` is
        ignored -- baselines replicate a null application (S9)."""
        key = keys[0] if keys else 0
        is_read = op == OpType.READ
        rid = request_id if request_id is not None else self._next_rid[client_id]
        if (client_id, rid) in self.records:
            raise ValueError(f"duplicate request id {(client_id, rid)}")
        self._next_rid[client_id] = max(self._next_rid[client_id], rid + 1)
        uid = (client_id, rid)
        self.records[uid] = Rec(submit_time=self.scheduler.now)
        self._dispatch(uid, key, is_read, attempt=0)
        self._arm_retry(uid, key, is_read, attempt=0)
        return uid

    def _arm_retry(self, uid, key, is_read, attempt) -> None:
        def maybe():
            rec = self.records[uid]
            if not np.isfinite(rec.commit_time) and rec.retries == attempt:
                rec.retries += 1
                self._dispatch(uid, key, is_read, attempt + 1)
                self._arm_retry(uid, key, is_read, attempt + 1)

        self.scheduler.schedule_after(self.cfg.client_timeout, maybe, tag="retry")

    def _commit(self, uid, fast_path: bool, extra: float = 0.0) -> None:
        rec = self.records.get(uid)
        if rec is None or np.isfinite(rec.commit_time):
            return
        rec.commit_time = self.scheduler.now
        rec.fast_path = fast_path
        rec.extra = extra
        if self.on_commit:
            self.on_commit(uid[0], uid[1])

    def _dispatch(self, uid, key, is_read, attempt) -> None:
        raise NotImplementedError

    def summary(self) -> dict:
        recs = list(self.records.values())
        fast = sum(1 for r in recs if r.fast_path and np.isfinite(r.commit_time))
        return summarize_commits(
            self.name, "event",
            [r.commit_time - r.submit_time for r in recs],
            n_requests=len(recs), n_fast=fast,
            leader_util=self.fabric.cpu_utilization(0),
        )


# ---------------------------------------------------------------------------
# Multi-Paxos / Raft
# ---------------------------------------------------------------------------
class MultiPaxos(_Base):
    """Leader-based, 4 message delays, f+1 quorum, quorum check at leader."""

    name = "MultiPaxos"
    leader = 0

    def __init__(self, cfg: BaselineConfig):
        super().__init__(cfg)
        self.log: list = []
        self.acks: dict[int, set[int]] = {}
        self.uid_of_slot: dict[int, tuple] = {}
        self._disk_pending = 0

    def _disk_delay_then(self, node: int, fn) -> None:
        """Optional per-batch fsync before acting (Raft mode)."""
        if self.cfg.disk_write_latency <= 0.0:
            fn()
            return
        # Group commits: amortize one fsync over up to disk_batch appends.
        self._disk_pending += 1
        if self._disk_pending >= self.cfg.disk_batch:
            self._disk_pending = 0
            self.scheduler.schedule_after(self.cfg.disk_write_latency, fn, tag="disk")
        else:
            self.scheduler.schedule_after(self.cfg.disk_write_latency, fn, tag="disk")

    def _dispatch(self, uid, key, is_read, attempt) -> None:
        cid = uid[0]
        self.fabric.send(self.client_node(cid), self.leader,
                         lambda: self._leader_on_request(uid))

    def _leader_on_request(self, uid) -> None:
        slot = len(self.log)
        self.log.append(uid)
        self.uid_of_slot[slot] = uid
        self.acks[slot] = {self.leader}

        def broadcast():
            for rid in range(self.n):
                if rid != self.leader:
                    self.fabric.send(
                        self.leader, rid,
                        (lambda s, r: lambda: self._follower_on_accept(s, r))(
                            slot, rid))

        self._disk_delay_then(self.leader, broadcast)

    def _follower_on_accept(self, slot: int, rid: int) -> None:
        def ack():
            # follower ack back to the leader, under its OWN identity: the
            # quorum set must see f+1 distinct replicas (a single positional
            # stand-in id capped the set at 2, so f >= 2 never committed)
            self.fabric.send(rid, self.leader,
                             lambda: self._leader_on_ack(slot, rid))

        self._disk_delay_then(0, ack)

    def _leader_on_ack(self, slot: int, rid: int) -> None:
        s = self.acks.get(slot)
        if s is None:
            return
        s.add(rid)
        if len(s) >= self.f + 1:
            del self.acks[slot]
            uid = self.uid_of_slot[slot]
            cid = uid[0]
            self.fabric.send(self.leader, self.client_node(cid),
                             lambda: self._commit(uid, fast_path=False))


class Raft(MultiPaxos):
    """Raft == Multi-Paxos message shape; S9.10 uses disk_write_latency > 0."""

    name = "Raft"


# ---------------------------------------------------------------------------
# Fast Paxos
# ---------------------------------------------------------------------------
class FastPaxos(_Base):
    """Client multicast; arrival-order slots; leader quorum check.

    Fast: 3 delays (client->replicas->leader->client) if a super quorum saw
    the request at the same position. Slow: +1 coordination RTT (5 delays).
    """

    name = "FastPaxos"
    leader = 0

    def __init__(self, cfg: BaselineConfig):
        super().__init__(cfg)
        self.positions: list[int] = [0] * self.n     # next arrival index per replica
        self.reports: dict[tuple, dict[int, int]] = {}
        self.done: set = set()
        self.slow_acks: dict[tuple, set[int]] = {}

    def _dispatch(self, uid, key, is_read, attempt) -> None:
        cid = uid[0]
        cnode = self.client_node(cid)
        for rid in range(self.n):
            self.fabric.send(cnode, rid,
                             (lambda r: lambda: self._replica_on_request(uid, r))(rid))

    def _replica_on_request(self, uid, rid: int) -> None:
        pos = self.positions[rid]
        self.positions[rid] += 1
        self.fabric.send(rid, self.leader, lambda: self._leader_on_report(uid, rid, pos))

    def _leader_on_report(self, uid, rid: int, pos: int) -> None:
        if uid in self.done:
            return
        rep = self.reports.setdefault(uid, {})
        rep[rid] = pos
        fq = fast_quorum_size(self.f)
        if len(rep) >= fq:
            vals = list(rep.values())
            best, cnt = max(((v, vals.count(v)) for v in set(vals)), key=lambda t: t[1])
            if cnt >= fq:
                self.done.add(uid)
                self.fabric.send(self.leader, self.client_node(uid[0]),
                                 lambda: self._commit(uid, fast_path=True))
                return
        if len(rep) == self.n:  # all reported, no fast quorum -> slow round
            self.done.add(uid)
            self.slow_acks[uid] = {self.leader}
            for rid2 in range(self.n):
                if rid2 != self.leader:
                    self.fabric.send(self.leader, rid2,
                                     (lambda r: lambda: self._follower_on_slow(uid, r))(rid2))

    def _follower_on_slow(self, uid, rid: int) -> None:
        self.fabric.send(rid, self.leader, lambda: self._leader_on_slow_ack(uid, rid))

    def _leader_on_slow_ack(self, uid, rid: int) -> None:
        s = self.slow_acks.get(uid)
        if s is None:
            return
        s.add(rid)
        if len(s) >= self.f + 1:
            del self.slow_acks[uid]
            self.fabric.send(self.leader, self.client_node(uid[0]),
                             lambda: self._commit(uid, fast_path=False))


# ---------------------------------------------------------------------------
# NOPaxos (software sequencer)
# ---------------------------------------------------------------------------
class NOPaxos(_Base):
    """Software sequencer -> replicas; seq-ordered delivery with gap handling.

    `optimized=False`: a gap stalls the replica's processing thread for one
    leader round-trip (the paper's observed behavior). `optimized=True`: the
    fetch happens off-thread; only the gapped slot's commit waits.
    """

    name = "NOPaxos"
    optimized = False
    leader = 0

    def __init__(self, cfg: BaselineConfig):
        super().__init__(cfg, n_extra_nodes=1)   # the sequencer
        self.seq_node = self._extra_base
        self.fabric.set_cpu(self.seq_node, cfg.sequencer_cpu)
        self.next_seq = 0
        self.expected: list[int] = [0] * self.n   # per-replica next seq
        self.buffered: list[dict[int, tuple]] = [dict() for _ in range(self.n)]
        self.replies: dict[tuple, set[int]] = {}
        self.uid_of_seq: dict[int, tuple] = {}
        self.gap_pending: list[Optional[int]] = [None] * self.n

    def _dispatch(self, uid, key, is_read, attempt) -> None:
        cid = uid[0]
        self.fabric.send(self.client_node(cid), self.seq_node,
                         lambda: self._sequencer_on_request(uid))

    def _sequencer_on_request(self, uid) -> None:
        seq = self.next_seq
        self.next_seq += 1
        self.uid_of_seq[seq] = uid
        for rid in range(self.n):
            self.fabric.send(self.seq_node, rid,
                             (lambda r, s: lambda: self._replica_on_marked(uid, s, r))(rid, seq))

    def _replica_on_marked(self, uid, seq: int, rid: int) -> None:
        if seq < self.expected[rid]:
            return  # duplicate
        self.buffered[rid][seq] = uid
        self._drain(rid)

    def _drain(self, rid: int) -> None:
        while self.expected[rid] in self.buffered[rid]:
            seq = self.expected[rid]
            uid = self.buffered[rid].pop(seq)
            self.expected[rid] += 1
            self.fabric.send(rid, self.client_node(uid[0]),
                             (lambda u, r: lambda: self._client_on_reply(u, r))(uid, rid))
        # Gap? Ask the leader (gap agreement), costing one RTT. At most one
        # outstanding gap per replica (sequential gap handling).
        buf = self.buffered[rid]
        for k in [k for k in buf if k < self.expected[rid]]:
            del buf[k]  # stale entries from resolved gaps
        if buf and min(buf) > self.expected[rid] and self.gap_pending[rid] is None:
            missing = self.expected[rid]
            self.gap_pending[rid] = missing
            rtt = 2 * 130e-6
            if not self.optimized:
                # sequential gap handling blocks this replica's CPU
                self.fabric.local(rid, lambda: None, cost=rtt)

            def resolve(m=missing, r=rid):
                self.gap_pending[r] = None
                if m >= self.expected[r]:
                    # leader supplies the missing request (or no-op)
                    self.buffered[r][m] = self.uid_of_seq.get(m, (-1, -1))
                self._drain(r)

            self.scheduler.schedule_after(rtt, resolve, tag="gap")

    def _client_on_reply(self, uid, rid: int) -> None:
        if uid == (-1, -1):
            return
        s = self.replies.setdefault(uid, set())
        s.add(rid)
        if self.leader in s and len(s) >= self.f + 1:
            self._commit(uid, fast_path=True)


class NOPaxosOptim(NOPaxos):
    name = "NOPaxos-Optim"
    optimized = True


# ---------------------------------------------------------------------------
# Domino (DFP) -- commit latency; execution decoupled (S9.3.1)
# ---------------------------------------------------------------------------
class Domino(_Base):
    name = "Domino"

    def __init__(self, cfg: BaselineConfig, percentile: float = 95.0):
        super().__init__(cfg)
        self.percentile = percentile
        self.clocks = [Clock(i, cfg.clock, seed=cfg.seed) for i in range(self.n + cfg.n_clients)]
        self.est = [OwdEstimator(DomParams(percentile=percentile, clamp_d=400e-6))
                    for _ in range(self.n)]
        self.last_t: list[float] = [-math.inf] * self.n
        self.acks: dict[tuple, set[int]] = {}
        self.rejected: set = set()

    def _dispatch(self, uid, key, is_read, attempt) -> None:
        cid = uid[0]
        cnode = self.client_node(cid)
        now = self.scheduler.now
        bound = max(e.estimate(30e-9, 30e-9) for e in self.est)
        deadline = now + bound * (1.0 + 0.5 * attempt)
        for rid in range(self.n):
            self.fabric.send(cnode, rid,
                             (lambda r: lambda: self._replica_on_request(uid, deadline, r, now))(rid))

    def _replica_on_request(self, uid, deadline: float, rid: int, send_time: float) -> None:
        self.est[rid].record(send_time, self.scheduler.now)
        if self.scheduler.now > deadline or deadline <= self.last_t[rid]:
            return  # reject: arrived past its pre-assigned slot
        delay = max(0.0, deadline - self.scheduler.now)

        def accept():
            self.last_t[rid] = max(self.last_t[rid], deadline)
            self.fabric.send(rid, self.client_node(uid[0]),
                             lambda: self._client_on_ack(uid, rid))

        self.scheduler.schedule_after(delay, accept, tag="hold")

    def _client_on_ack(self, uid, rid: int) -> None:
        s = self.acks.setdefault(uid, set())
        s.add(rid)
        if len(s) >= fast_quorum_size(self.f):
            self._commit(uid, fast_path=True, extra=10e-3)  # exec lag >10ms (S9.3)


# ---------------------------------------------------------------------------
# TOQ-EPaxos -- commit latency (S9.3.2)
# ---------------------------------------------------------------------------
class TOQEPaxos(_Base):
    name = "TOQ-EPaxos"

    def __init__(self, cfg: BaselineConfig, conflict_window: float = 150e-6):
        super().__init__(cfg)
        self.conflict_window = conflict_window
        self.inflight_keys: dict[int, float] = {}   # key -> last pre-accept time
        self.preacks: dict[tuple, set[int]] = {}
        self.conflicted: set = set()
        self.accacks: dict[tuple, set[int]] = {}

    def _dispatch(self, uid, key, is_read, attempt) -> None:
        cid = uid[0]
        cmd_leader = cid % self.n
        self.fabric.send(self.client_node(cid), cmd_leader,
                         lambda: self._leader_preaccept(uid, key, cmd_leader))

    def _leader_preaccept(self, uid, key: int, L: int) -> None:
        now = self.scheduler.now
        conflict = (key in self.inflight_keys and
                    now - self.inflight_keys[key] < self.conflict_window)
        self.inflight_keys[key] = now
        if conflict:
            self.conflicted.add(uid)
        self.preacks[uid] = {L}
        for rid in range(self.n):
            if rid != L:
                self.fabric.send(L, rid,
                                 (lambda r: lambda: self._peer_preack(uid, r, L))(rid))

    def _peer_preack(self, uid, rid: int, L: int) -> None:
        self.fabric.send(rid, L, lambda: self._leader_on_preack(uid, rid, L))

    def _leader_on_preack(self, uid, rid: int, L: int) -> None:
        s = self.preacks.get(uid)
        if s is None:
            return
        s.add(rid)
        fq = self.f + math.floor((self.f + 1) / 2)
        if len(s) >= fq:
            del self.preacks[uid]
            if uid not in self.conflicted:
                self.fabric.send(L, self.client_node(uid[0]),
                                 lambda: self._commit(uid, fast_path=True, extra=2e-3))
            else:  # second (Accept) round
                self.accacks[uid] = {L}
                for rid2 in range(self.n):
                    if rid2 != L:
                        self.fabric.send(L, rid2,
                                         (lambda r: lambda: self._peer_accack(uid, r, L))(rid2))

    def _peer_accack(self, uid, rid: int, L: int) -> None:
        self.fabric.send(rid, L, lambda: self._leader_on_accack(uid, rid, L))

    def _leader_on_accack(self, uid, rid: int, L: int) -> None:
        s = self.accacks.get(uid)
        if s is None:
            return
        s.add(rid)
        if len(s) >= self.f + 1:
            del self.accacks[uid]
            self.fabric.send(L, self.client_node(uid[0]),
                             lambda: self._commit(uid, fast_path=False, extra=2e-3))


# ---------------------------------------------------------------------------
# Unreplicated server (S10 application baseline)
# ---------------------------------------------------------------------------
class Unreplicated(_Base):
    name = "Unreplicated"

    def _dispatch(self, uid, key, is_read, attempt) -> None:
        cid = uid[0]

        def serve():
            if self.cfg.exec_cost > 0:
                self.fabric.local(0, lambda: self._reply(uid, cid), cost=self.cfg.exec_cost)
            else:
                self._reply(uid, cid)

        self.fabric.send(self.client_node(cid), 0, serve)

    def _reply(self, uid, cid) -> None:
        self.fabric.send(0, self.client_node(cid), lambda: self._commit(uid, fast_path=True))


PROTOCOLS = {
    "multipaxos": MultiPaxos,
    "raft": Raft,
    "fastpaxos": FastPaxos,
    "nopaxos": NOPaxos,
    "nopaxos-optim": NOPaxosOptim,
    "domino": Domino,
    "toq-epaxos": TOQEPaxos,
    "unreplicated": Unreplicated,
}

__all__ = ["BaselineConfig", "MultiPaxos", "Raft", "FastPaxos", "NOPaxos",
           "NOPaxosOptim", "Domino", "TOQEPaxos", "Unreplicated", "PROTOCOLS"]
