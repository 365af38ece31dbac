"""Port of `repro/core/replica.py` (copied).

The Nezha replica (paper S6, Algorithms 1, 3, 4).

Event-driven, exact implementation: DOM receiver (early/late buffers), the
synced/unsynced log split, speculative execution at the leader, incremental
(optionally per-key) hashing, log-modification/log-status flow, periodic
commit-point checkpoints, crash-vector-guarded diskless recovery, and
view changes.

The replica is transport-agnostic: it talks to the world through a `Cluster`
interface (see repro_torch.core.protocol) providing `send(src, dst, msg)`,
`broadcast_replicas(src, msg)`, a scheduler, and per-node clocks.
"""
from __future__ import annotations

import math
import uuid
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np

from repro_torch.core import recovery as rec
from repro_torch.core.dom import DomParams, DomReceiver
from repro_torch.core.hashing import IncrementalHash, PerKeyHashTable, crash_vector_hash_np
from repro_torch.core.messages import (
    CommitNotice,
    CrashVectorRep,
    CrashVectorReq,
    FastReply,
    LogEntry,
    LogModification,
    LogStatus,
    OpType,
    RecoveryRep,
    RecoveryReq,
    Request,
    SlowReply,
    StartView,
    StateTransferRep,
    StateTransferReq,
    Status,
    ViewChange,
    ViewChangeReq,
)
from repro_torch.core.quorum import leader_of_view, n_replicas


# ---------------------------------------------------------------------------
# Replicated state machines (the paper's "null app", KV store, exchange)
# ---------------------------------------------------------------------------
class StateMachine:
    def execute(self, command) -> object:
        raise NotImplementedError

    def snapshot(self) -> object:
        raise NotImplementedError

    def restore(self, snap) -> None:
        raise NotImplementedError


class NullApp(StateMachine):
    """S9.1's null application: execution returns a monotone token."""

    def __init__(self):
        self.count = 0

    def execute(self, command) -> object:
        self.count += 1
        return self.count

    def snapshot(self):
        return self.count

    def restore(self, snap):
        self.count = snap


class KVStore(StateMachine):
    """Commands: ("GET", k) | ("SET", k, v) | ("RMW", k_from, k_to, amount)."""

    def __init__(self):
        self.d: dict = {}

    def execute(self, command):
        op = command[0]
        if op == "GET":
            return self.d.get(command[1])
        if op == "SET":
            self.d[command[1]] = command[2]
            return "OK"
        if op == "RMW":
            _, src, dst, amt = command
            a, b = self.d.get(src, 0), self.d.get(dst, 0)
            self.d[src], self.d[dst] = a - amt, b + amt
            return (a - amt, b + amt)
        if op == "NOOP" or op is None:
            return None
        raise ValueError(f"unknown op {op!r}")

    def snapshot(self):
        return dict(self.d)

    def restore(self, snap):
        self.d = dict(snap)


@dataclass
class ReplicaParams:
    dom: DomParams = None                      # type: ignore[assignment]
    commutative: bool = True
    batch_interval: float = 50e-6              # log-modification batching window
    status_interval: float = 200e-6            # follower log-status cadence
    commit_interval: float = 1e-3              # leader commit-point broadcast
    heartbeat_timeout: float = 25e-3           # follower -> view change trigger
    viewchange_resend: float = 10e-3
    recovery_resend: float = 10e-3
    pump_epsilon: float = 1e-7                 # release re-check granularity
    checkpoint_accel: bool = True              # S8.3 periodic checkpoints
    deadline_cap: float = 0.0                  # SD.2.4 optimization: leader caps
    #   far-future deadlines (0 = disabled); e.g. 50e-6 enables the bound.
    disk_write_latency: float = 0.0            # S9.10 disk-based mode: persist
    #   the log entry (group-committed) before any reply leaves the replica.
    attach_requests_to_mods: bool = False      # No-DOM ablation: the leader
    #   multicasts full request payloads (unbatchable) like Multi-Paxos.

    def __post_init__(self):
        if self.dom is None:
            self.dom = DomParams()


class Replica:
    def __init__(
        self,
        replica_id: int,
        f: int,
        cluster,
        params: Optional[ReplicaParams] = None,
        sm_factory: Callable[[], StateMachine] = NullApp,
    ):
        self.id = replica_id
        self.f = f
        self.n = n_replicas(f)
        self.cluster = cluster
        self.p = params or ReplicaParams()
        self.sm_factory = sm_factory

        self.status = Status.NORMAL
        self.view_id = 0
        self.last_normal_view = 0
        self.crash_vector: tuple = tuple(0 for _ in range(self.n))

        # Logs. Leader: synced only. Followers: synced prefix + unsynced tail.
        self.synced: list[LogEntry] = []
        self.unsynced: dict[tuple[int, int], LogEntry] = {}
        self.commit_point = 0       # count of committed entries (S8.3)
        self.executed_point = 0     # entries applied to self.sm

        self.sm: StateMachine = sm_factory()
        self.results: dict[tuple[int, int], object] = {}   # uid -> exec result
        self.replied: dict[tuple[int, int], FastReply] = {}  # at-most-once cache

        # Hashing (S8.1/S8.2).
        self.ghash = IncrementalHash(self.crash_vector)
        self.khash = PerKeyHashTable()

        # DOM receiver.
        self.dom = DomReceiver(self.p.dom, commutative=self.p.commutative,
                               on_release=self._on_release)

        # Follower-side log-modification bookkeeping.
        self.pending_mods: dict[int, LogModification] = {}
        self.fetching: set[tuple[int, int]] = set()

        # Failure-detector / timers.
        self.last_leader_msg = 0.0
        self.alive = True

        # LossyAcker fault model (scenario): a lossy replica keeps acking
        # without durably persisting, so its durable prefix freezes at
        # `_persist_mark`. A later crash snapshots the truncated log; the
        # relaunch then restarts *divergent* -- trusting that truncated log
        # in its stale view instead of running Alg 3 recovery.
        self.lossy = False
        self.divergent = False
        self._persist_mark = 0
        self._lossy_snapshot: Optional[dict] = None
        self._mod_batch: list[LogModification] = []
        self._pump_scheduled_for = math.inf
        self._vc_replies: dict[int, ViewChange] = {}
        self._recovery_state: Optional[dict] = None
        self.stats = {"msgs_in": 0, "msgs_out": 0, "fast_replies": 0,
                      "slow_replies": 0, "mods": 0, "releases": 0,
                      "slow_path_enters": 0, "view_changes": 0,
                      "recovered_entries": 0, "dropped_speculative": 0}

    # -- identity helpers -----------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return self.status == Status.NORMAL and leader_of_view(self.view_id, self.f) == self.id

    @property
    def clock(self):
        return self.cluster.clock_of_replica(self.id)

    def local_time(self) -> float:
        return self.clock.read_monotonic(self.cluster.scheduler.now)

    @property
    def sync_point(self) -> int:
        return len(self.synced)

    def log_view(self) -> list[LogEntry]:
        """Combined (synced + deadline-ordered unsynced) log."""
        tail = sorted(self.unsynced.values(), key=lambda e: (e.deadline, e.client_id, e.request_id))
        return self.synced + tail

    # -- timers ---------------------------------------------------------------
    def start(self) -> None:
        sch = self.cluster.scheduler
        self.last_leader_msg = sch.now
        sch.schedule_after(self.p.batch_interval, self._flush_mods, tag=f"r{self.id}-batch")
        sch.schedule_after(self.p.status_interval, self._send_status, tag=f"r{self.id}-status")
        sch.schedule_after(self.p.commit_interval, self._commit_tick, tag=f"r{self.id}-commit")
        sch.schedule_after(self.p.heartbeat_timeout, self._check_leader, tag=f"r{self.id}-fd")

    # ==========================================================================
    # Normal operation (Algorithm 1)
    # ==========================================================================
    def handle(self, msg, src: int) -> None:
        if not self.alive:
            return
        self.stats["msgs_in"] += 1
        if isinstance(msg, Request):
            self._on_request(msg)
        elif isinstance(msg, LogModification):
            self._on_log_modification(msg, src)
        elif isinstance(msg, list) and msg and isinstance(msg[0], LogModification):
            for m in msg:
                self._on_log_modification(m, src)
        elif isinstance(msg, LogStatus):
            self._on_log_status(msg)
        elif isinstance(msg, CommitNotice):
            self._on_commit_notice(msg)
        elif isinstance(msg, _FetchReq):
            self._on_fetch_req(msg, src)
        elif isinstance(msg, _FetchRep):
            self._on_fetch_rep(msg)
        elif isinstance(msg, CrashVectorReq):
            self._on_cv_req(msg, src)
        elif isinstance(msg, CrashVectorRep):
            self._on_cv_rep(msg)
        elif isinstance(msg, RecoveryReq):
            self._on_recovery_req(msg, src)
        elif isinstance(msg, RecoveryRep):
            self._on_recovery_rep(msg)
        elif isinstance(msg, StateTransferReq):
            self._on_state_transfer_req(msg, src)
        elif isinstance(msg, StateTransferRep):
            self._on_state_transfer_rep(msg)
        elif isinstance(msg, ViewChangeReq):
            self._on_view_change_req(msg)
        elif isinstance(msg, ViewChange):
            self._on_view_change(msg)
        elif isinstance(msg, StartView):
            self._on_start_view(msg)

    # -- request arrival -------------------------------------------------------
    def _on_request(self, req: Request) -> None:
        if self.status != Status.NORMAL:
            return
        # At-most-once (S6.5): duplicate uid -> replay a reply that can still
        # contribute to a quorum in the *current* view.
        if req.uid in self._synced_uids():
            if self.is_leader:
                e = self._find_synced(req.uid)
                self._send_reply(self._make_fast_reply(e, result=self.results.get(req.uid)),
                                 req.proxy_id)
            else:
                self._send_reply(SlowReply(view_id=self.view_id, replica_id=self.id,
                                           client_id=req.client_id,
                                           request_id=req.request_id), req.proxy_id)
            return
        if req.uid in self.unsynced:
            self._send_reply(self.replied.get(req.uid) or
                             self._make_fast_reply(self.unsynced[req.uid], result=None),
                             req.proxy_id)
            return
        if req.uid in self.fetching:
            return  # already in flight at this replica
        now_local = self.local_time()
        if self.is_leader and self.p.deadline_cap > 0.0 and \
                req.deadline > now_local + self.p.deadline_cap:
            # Appendix D.2.4 optimization: bound the holding delay under bad
            # clock sync (fast proxy clocks) by pulling far-future deadlines
            # back; the request then commits via the slow path.
            req = req.with_deadline(
                max(now_local, self.dom.early.last_released_deadline(req) + 1e-9))
        entered, owd = self.dom.receive(
            req, now_local,
            sigma_s=self.cluster.sigma_of_proxy(req.proxy_id),
            sigma_r=self.clock.sigma_estimate,
        )
        self.cluster.report_owd(self.id, req.proxy_id, owd)
        if not entered:
            if self.is_leader:
                # Slow path (Fig 5 step 3): overwrite the deadline so the
                # request can enter the early-buffer.
                self.stats["slow_path_enters"] += 1
                new_ddl = max(now_local,
                              self.dom.early.last_released_deadline(req) + 1e-9)
                req2 = req.with_deadline(new_ddl)
                self.dom.early.insert(req2)
                self._schedule_pump(req2.deadline, now_local)
            # Followers keep it in the late-buffer (already inserted by DOM).
            return
        self._schedule_pump(req.deadline, now_local)

    def _synced_uids(self) -> set:
        if not hasattr(self, "_synced_set"):
            self._synced_set = {e.uid for e in self.synced}
        return self._synced_set

    def _find_synced(self, uid) -> LogEntry:
        for e in reversed(self.synced):
            if e.uid == uid:
                return e
        raise KeyError(uid)

    def _schedule_pump(self, deadline: float, now_local: float) -> None:
        sch = self.cluster.scheduler
        delay = max(deadline - now_local, 0.0) + self.p.pump_epsilon
        when = sch.now + delay
        if when < self._pump_scheduled_for - 1e-12:
            self._pump_scheduled_for = when
            sch.schedule_at(when, self._pump, tag=f"r{self.id}-pump")

    def _pump(self) -> None:
        self._pump_scheduled_for = math.inf
        if not self.alive or self.status != Status.NORMAL:
            return
        now_local = self.local_time()
        self.dom.pump(now_local)
        nxt = self.dom.early.peek_deadline()
        if nxt is not None:
            self._schedule_pump(nxt, now_local)

    # -- release -> append (Algorithm 1 lines 11-24) ----------------------------
    def _on_release(self, req: Request) -> None:
        self.stats["releases"] += 1
        entry = LogEntry(deadline=req.deadline, client_id=req.client_id,
                         request_id=req.request_id, request=req)
        if self.is_leader:
            entry.result = self._execute(entry)
            self.synced.append(entry)
            self._synced_uids().add(entry.uid)
            self._hash_add(entry)
            fr = self._make_fast_reply(entry, result=entry.result)
            self.replied[entry.uid] = fr
            self._send_reply(fr, req.proxy_id)
            self.stats["fast_replies"] += 1
            mod = LogModification(view_id=self.view_id, log_id=len(self.synced) - 1,
                                  client_id=entry.client_id, request_id=entry.request_id,
                                  deadline=entry.deadline,
                                  request=req if self.p.attach_requests_to_mods else None)
            self.stats["mods"] += 1
            if self.p.attach_requests_to_mods:
                # full-payload multicast cannot amortize: one message per
                # request per follower (the Multi-Paxos-shaped leader load)
                for rid in range(self.n):
                    if rid != self.id:
                        self.stats["msgs_out"] += 1
                        self.cluster.send_replica(self.id, rid, [mod])
            else:
                self._mod_batch.append(mod)
        else:
            self.unsynced[entry.uid] = entry
            self._hash_add(entry)
            fr = self._make_fast_reply(entry, result=None)
            self.replied[entry.uid] = fr
            self._send_reply(fr, req.proxy_id)
            self.stats["fast_replies"] += 1

    def _execute(self, entry: LogEntry) -> object:
        if hasattr(self.cluster, "charge_exec"):
            self.cluster.charge_exec(self.id)
        res = self.sm.execute(entry.request.command)
        self.results[entry.uid] = res
        self.executed_point = len(self.synced) + 1
        return res

    def _hash_add(self, entry: LogEntry) -> None:
        ns = _ns(entry.deadline)
        self.ghash.add(ns, entry.client_id, entry.request_id)
        if self.p.commutative and entry.request.is_write:
            for k in entry.request.keys or ("__all__",):
                self.khash.add_write(_key_int(k), ns, entry.client_id, entry.request_id)

    def _hash_remove(self, entry: LogEntry) -> None:
        ns = _ns(entry.deadline)
        self.ghash.remove(ns, entry.client_id, entry.request_id)
        if self.p.commutative and entry.request.is_write:
            for k in entry.request.keys or ("__all__",):
                self.khash.remove_write(_key_int(k), ns, entry.client_id, entry.request_id)

    def _reply_hash(self, entry: LogEntry) -> int:
        cvh = int(crash_vector_hash_np(self.crash_vector))
        if self.p.commutative:
            keys = [_key_int(k) for k in (entry.request.keys or ("__all__",))]
            return self.khash.reply_hash(keys) ^ cvh
        return self.ghash.set_hash ^ cvh

    def _make_fast_reply(self, entry: LogEntry, result) -> FastReply:
        return FastReply(view_id=self.view_id, replica_id=self.id,
                         client_id=entry.client_id, request_id=entry.request_id,
                         result=result, hash=self._reply_hash(entry),
                         deadline=entry.deadline)

    def _send_reply(self, msg, proxy_id: int) -> None:
        self.stats["msgs_out"] += 1
        if self.p.disk_write_latency > 0.0:
            # disk-based operation (S9.10): group-commit fsync before replying
            self.cluster.scheduler.schedule_after(
                self.p.disk_write_latency,
                lambda: self.cluster.send_to_proxy(self.id, proxy_id, msg),
                tag=f"r{self.id}-fsync")
            return
        self.cluster.send_to_proxy(self.id, proxy_id, msg)

    # -- leader: broadcast log-modifications ------------------------------------
    def _flush_mods(self) -> None:
        if self.alive and self.status == Status.NORMAL and self.is_leader:
            now = self.cluster.scheduler.now
            idle = now - getattr(self, "_last_mod_send", 0.0)
            if self._mod_batch or idle > self.p.heartbeat_timeout / 4:
                batch = self._mod_batch or [
                    LogModification(view_id=self.view_id, log_id=-1,
                                    client_id=-1, request_id=-1, deadline=0.0)
                ]  # an empty batch doubles as the heartbeat
                self._mod_batch = []
                self._last_mod_send = now
                for rid in range(self.n):
                    if rid != self.id:
                        self.stats["msgs_out"] += 1
                        self.cluster.send_replica(self.id, rid, list(batch))
        if self.alive:
            self.cluster.scheduler.schedule_after(self.p.batch_interval, self._flush_mods,
                                                  tag=f"r{self.id}-batch")

    # -- follower: apply log-modifications (S6.4) -------------------------------
    def _on_log_modification(self, mod: LogModification, src: int) -> None:
        if self.status != Status.NORMAL or self.is_leader:
            return
        if mod.view_id != self.view_id:
            if mod.view_id > self.view_id:
                self._initiate_view_change(mod.view_id)  # we lag; catch up
            return
        self.last_leader_msg = self.cluster.scheduler.now
        if mod.log_id < 0:
            return  # pure heartbeat
        if mod.log_id < len(self.synced):
            return  # duplicate
        existing = self.pending_mods.get(mod.log_id)
        if existing is not None and existing.request is not None and mod.request is None:
            pass  # never downgrade a payload-carrying mod to a bare one
        else:
            self.pending_mods[mod.log_id] = mod
        self._drain_mods()

    def _drain_mods(self) -> None:
        progressed = False
        while len(self.synced) in self.pending_mods:
            mod = self.pending_mods[len(self.synced)]
            entry = self._materialize(mod)
            if entry is None:
                break  # fetch in flight; resume on arrival
            del self.pending_mods[mod.log_id]
            self._evict_unsynced_below(entry)
            self.synced.append(entry)
            self._synced_uids().add(entry.uid)
            progressed = True
            sr = SlowReply(view_id=self.view_id, replica_id=self.id,
                           client_id=entry.client_id, request_id=entry.request_id)
            self.stats["slow_replies"] += 1
            self._send_reply(sr, entry.request.proxy_id)
        if progressed and self.p.checkpoint_accel:
            self._maybe_execute_to_commit_point()

    def _materialize(self, mod: LogModification) -> Optional[LogEntry]:
        uid = (mod.client_id, mod.request_id)
        # (1)/(2): entry released here (unsynced), possibly with stale deadline.
        if uid in self.unsynced:
            e = self.unsynced.pop(uid)
            if e.deadline != mod.deadline:
                self._hash_remove(e)
                e = LogEntry(deadline=mod.deadline, client_id=e.client_id,
                             request_id=e.request_id, request=e.request.with_deadline(mod.deadline))
                self._hash_add(e)
            return e
        # (No-DOM ablation) the payload rides on the mod itself.
        if mod.request is not None:
            e = LogEntry(deadline=mod.deadline, client_id=mod.client_id,
                         request_id=mod.request_id,
                         request=mod.request.with_deadline(mod.deadline))
            self._hash_add(e)
            return e
        # (3): in the late-buffer.
        req = self.dom.late.pop(mod.client_id, mod.request_id)
        if req is not None:
            e = LogEntry(deadline=mod.deadline, client_id=mod.client_id,
                         request_id=mod.request_id, request=req.with_deadline(mod.deadline))
            self._hash_add(e)
            return e
        # (rare) fetch from the leader.
        if uid not in self.fetching:
            self.fetching.add(uid)
            self.stats["msgs_out"] += 1
            self.cluster.send_replica(self.id, leader_of_view(self.view_id, self.f),
                                      _FetchReq(client_id=mod.client_id,
                                                request_id=mod.request_id,
                                                view_id=self.view_id))
        return None

    def _evict_unsynced_below(self, entry: LogEntry) -> None:
        """Unsynced entries that can never appear later in the leader's log
        are demoted to the late-buffer.

        Without commutativity the leader's log is globally deadline-sorted,
        so anything below the newly-synced deadline is doomed. With the
        commutativity optimization (S8.2) only the *per-key-class* order is
        sorted: evict only entries non-commutative with the synced one.
        """
        d = entry.deadline
        if self.p.commutative:
            ek = set(entry.request.keys or ("__all__",))
            doomed = [uid for uid, e in self.unsynced.items()
                      if e.deadline < d and uid != entry.uid
                      and (e.request.is_write or entry.request.is_write)
                      and ek & set(e.request.keys or ("__all__",))]
        else:
            doomed = [uid for uid, e in self.unsynced.items()
                      if e.deadline < d and uid != entry.uid]
        for uid in doomed:
            e = self.unsynced.pop(uid)
            self._hash_remove(e)
            self.dom.late.insert(e.request)

    def _on_fetch_req(self, msg: "_FetchReq", src: int) -> None:
        if self.status != Status.NORMAL:
            return
        uid = (msg.client_id, msg.request_id)
        for e in self.synced:
            if e.uid == uid:
                self.stats["msgs_out"] += 1
                self.cluster.send_replica(self.id, src,
                                          _FetchRep(entry=e, view_id=self.view_id))
                return
        if uid in self.unsynced:
            self.stats["msgs_out"] += 1
            self.cluster.send_replica(self.id, src,
                                      _FetchRep(entry=self.unsynced[uid], view_id=self.view_id))

    def _on_fetch_rep(self, msg: "_FetchRep") -> None:
        if self.status != Status.NORMAL or msg.view_id != self.view_id:
            return
        uid = msg.entry.uid
        if uid in self.fetching:
            self.fetching.discard(uid)
            self.dom.late.insert(msg.entry.request)
            self._drain_mods()

    # -- log-status / commit point (S8.3) ----------------------------------------
    def _send_status(self) -> None:
        if self.alive and self.status == Status.NORMAL and not self.is_leader:
            self.stats["msgs_out"] += 1
            self.cluster.send_replica(self.id, leader_of_view(self.view_id, self.f),
                                      LogStatus(view_id=self.view_id, replica_id=self.id,
                                                sync_point=self.sync_point))
        if self.alive:
            self.cluster.scheduler.schedule_after(self.p.status_interval, self._send_status,
                                                  tag=f"r{self.id}-status")

    def _on_log_status(self, msg: LogStatus) -> None:
        if not self.is_leader or msg.view_id != self.view_id:
            return
        self._follower_sp = getattr(self, "_follower_sp", {})
        self._follower_sp[msg.replica_id] = msg.sync_point
        # Repair: a lagging follower lost log-modifications (UDP-style drops);
        # retransmit a window starting at its sync-point.
        if msg.sync_point < self.sync_point:
            lo = msg.sync_point
            hi = min(self.sync_point, lo + 256)
            batch = [LogModification(view_id=self.view_id, log_id=i,
                                     client_id=self.synced[i].client_id,
                                     request_id=self.synced[i].request_id,
                                     deadline=self.synced[i].deadline,
                                     request=(self.synced[i].request
                                              if self.p.attach_requests_to_mods else None))
                     for i in range(lo, hi)]
            if batch:
                self.stats["msgs_out"] += 1
                self.cluster.send_replica(self.id, msg.replica_id, batch)

    def _commit_tick(self) -> None:
        if self.alive and self.is_leader:
            sps = sorted(
                list(getattr(self, "_follower_sp", {}).values()) + [self.sync_point],
                reverse=True,
            )
            if len(sps) >= self.f + 1:
                cp = sps[self.f]  # smallest among the top f+1 sync-points
                if cp > self.commit_point:
                    self.commit_point = cp
                    for rid in range(self.n):
                        if rid != self.id:
                            self.stats["msgs_out"] += 1
                            self.cluster.send_replica(self.id, rid,
                                                      CommitNotice(view_id=self.view_id,
                                                                   commit_point=cp))
        if self.alive:
            self.cluster.scheduler.schedule_after(self.p.commit_interval, self._commit_tick,
                                                  tag=f"r{self.id}-commit")

    def _on_commit_notice(self, msg: CommitNotice) -> None:
        if self.status != Status.NORMAL or msg.view_id != self.view_id:
            return
        self.last_leader_msg = self.cluster.scheduler.now
        self.commit_point = max(self.commit_point, min(msg.commit_point, self.sync_point))
        if self.p.checkpoint_accel:
            self._maybe_execute_to_commit_point()

    def _maybe_execute_to_commit_point(self) -> None:
        """Followers lazily execute committed entries so a future leader
        change only replays the suffix (S8.3)."""
        while self.executed_point < min(self.commit_point, self.sync_point):
            e = self.synced[self.executed_point]
            res = self.sm.execute(e.request.command)
            self.results[e.uid] = res
            self.executed_point += 1

    # ==========================================================================
    # Failure handling
    # ==========================================================================
    def set_lossy(self) -> None:
        """LossyAcker fault (scenario): from now on this replica acks
        without persisting -- its durable prefix freezes at today's length."""
        if not self.lossy:
            self.lossy = True
            self._persist_mark = len(self.synced)

    def crash(self) -> None:
        self.alive = False
        if self.lossy:
            acked = len(self.synced)
            gap = self.synced[self._persist_mark:]
            if gap:
                sink = getattr(self.cluster, "_durability_events", None)
                if sink is not None:
                    sink.append({
                        "replica": self.id, "acked": acked,
                        "persisted": self._persist_mark, "missing": len(gap),
                        "uids": rec.pack_uids(
                            np.asarray([e.client_id for e in gap], np.int64),
                            np.asarray([e.request_id for e in gap], np.int64)),
                    })
            # What the disk actually holds: the frozen prefix + stale view.
            self._lossy_snapshot = {
                "view_id": self.view_id,
                "last_normal_view": self.last_normal_view,
                "crash_vector": self.crash_vector,
                "synced": list(self.synced[: self._persist_mark]),
            }

    def relaunch(self) -> None:
        """Process restart on the same server: stable storage holds only
        replica-id (S7). Everything else is recovered from peers (Alg 3)."""
        if self._lossy_snapshot is not None:
            self._relaunch_divergent()
            return
        self.alive = True
        self.status = Status.RECOVERING
        self.synced, self.unsynced = [], {}
        self._synced_set = set()
        self.pending_mods, self.fetching = {}, set()
        self.replied, self.results = {}, {}
        self.sm = self.sm_factory()
        self.executed_point = 0
        self.commit_point = 0
        self.ghash = IncrementalHash(self.crash_vector)
        self.khash = PerKeyHashTable()
        self.dom = DomReceiver(self.p.dom, commutative=self.p.commutative,
                               on_release=self._on_release)
        self._recovery_state = {"phase": "cv", "nonce": uuid.uuid4().hex, "cv_reps": {},
                                "rec_reps": {}}
        self._broadcast_cv_req()
        self.start()

    def _relaunch_divergent(self) -> None:
        """Byzantine-leaning restart (LossyAcker): the replica trusts its
        truncated 'durable' log, skips Alg 3 entirely, and resumes NORMAL
        in its stale view. If that stale view still elects it leader it
        will happily append new entries on top of the truncated prefix --
        producing a durable log that positionally conflicts with the honest
        majority's (the split-brain evidence `check_split_brain` hunts)."""
        snap = self._lossy_snapshot
        self.alive = True
        self.status = Status.NORMAL
        self.divergent = True
        self.view_id = snap["view_id"]
        self.last_normal_view = snap["last_normal_view"]
        self.crash_vector = snap["crash_vector"]
        self.synced = list(snap["synced"])
        self.unsynced = {}
        self._synced_set = {e.uid for e in self.synced}
        self.pending_mods, self.fetching = {}, set()
        self.replied, self.results = {}, {}
        self.sm = self.sm_factory()
        self.executed_point = 0
        self.commit_point = 0
        self.ghash = IncrementalHash(self.crash_vector)
        self.khash = PerKeyHashTable()
        for e in self.synced:
            self._hash_add(e)
        self.dom = DomReceiver(self.p.dom, commutative=self.p.commutative,
                               on_release=self._on_release)
        self._recovery_state = None
        self.start()

    def _broadcast_cv_req(self) -> None:
        st = self._recovery_state
        if st is None or st["phase"] != "cv" or not self.alive:
            return
        for rid in range(self.n):
            if rid != self.id:
                self.stats["msgs_out"] += 1
                self.cluster.send_replica(self.id, rid,
                                          CrashVectorReq(replica_id=self.id, nonce=st["nonce"]))
        self.cluster.scheduler.schedule_after(self.p.recovery_resend, self._broadcast_cv_req,
                                              tag=f"r{self.id}-cvreq")

    def _on_cv_req(self, msg: CrashVectorReq, src: int) -> None:
        if self.status != Status.NORMAL:
            return
        self.stats["msgs_out"] += 1
        self.cluster.send_replica(self.id, src,
                                  CrashVectorRep(replica_id=self.id, nonce=msg.nonce,
                                                 crash_vector=self.crash_vector))

    def _on_cv_rep(self, msg: CrashVectorRep) -> None:
        st = self._recovery_state
        if st is None or st["phase"] != "cv" or msg.nonce != st["nonce"]:
            return
        st["cv_reps"][msg.replica_id] = msg.crash_vector
        if len(st["cv_reps"]) + 1 >= self.f + 1:
            cv = list(rec.aggregate_crash_vectors(
                list(st["cv_reps"].values()) + [self.crash_vector]))
            cv[self.id] += 1          # increment own counter (Alg 3 line 8)
            self.crash_vector = tuple(cv)
            self.ghash.set_crash_vector(self.crash_vector)
            st["phase"] = "recovery"
            self._broadcast_recovery_req()

    def _broadcast_recovery_req(self) -> None:
        st = self._recovery_state
        if st is None or st["phase"] != "recovery" or not self.alive:
            return
        for rid in range(self.n):
            if rid != self.id:
                self.stats["msgs_out"] += 1
                self.cluster.send_replica(self.id, rid,
                                          RecoveryReq(replica_id=self.id,
                                                      crash_vector=self.crash_vector))
        self.cluster.scheduler.schedule_after(self.p.recovery_resend,
                                              self._broadcast_recovery_req,
                                              tag=f"r{self.id}-recreq")

    def _on_recovery_req(self, msg: RecoveryReq, src: int) -> None:
        if self.status != Status.NORMAL:
            return
        if not rec.check_crash_vector(self.crash_vector, msg.replica_id, msg.crash_vector):
            return
        self.crash_vector = rec.aggregate_crash_vectors([self.crash_vector, msg.crash_vector])
        self.ghash.set_crash_vector(self.crash_vector)
        self.stats["msgs_out"] += 1
        self.cluster.send_replica(self.id, src,
                                  RecoveryRep(replica_id=self.id, view_id=self.view_id,
                                              crash_vector=self.crash_vector))

    def _on_recovery_rep(self, msg: RecoveryRep) -> None:
        st = self._recovery_state
        if st is None or st["phase"] != "recovery":
            return
        if not rec.check_crash_vector(self.crash_vector, msg.replica_id, msg.crash_vector):
            return
        self.crash_vector = rec.aggregate_crash_vectors([self.crash_vector, msg.crash_vector])
        self.ghash.set_crash_vector(self.crash_vector)
        # Remove now-stale replies (Alg 3 lines 69-71).
        st["rec_reps"] = {rid: m for rid, m in st["rec_reps"].items()
                          if m.crash_vector[rid] >= self.crash_vector[rid]}
        st["rec_reps"][msg.replica_id] = msg
        if len(st["rec_reps"]) >= self.f + 1:
            hv = rec.highest_view(list(st["rec_reps"].values()))
            leader = leader_of_view(hv, self.f)
            if leader == self.id:
                return  # keep re-broadcasting until a majority elects another
            st["phase"] = "transfer"
            st["target_view"] = hv
            self.stats["msgs_out"] += 1
            self.cluster.send_replica(self.id, leader,
                                      StateTransferReq(replica_id=self.id,
                                                       crash_vector=self.crash_vector))

    def _on_state_transfer_req(self, msg: StateTransferReq, src: int) -> None:
        if self.status != Status.NORMAL:
            return
        if not rec.check_crash_vector(self.crash_vector, msg.replica_id, msg.crash_vector):
            return
        self.crash_vector = rec.aggregate_crash_vectors([self.crash_vector, msg.crash_vector])
        self.ghash.set_crash_vector(self.crash_vector)
        self.stats["msgs_out"] += 1
        self.cluster.send_replica(self.id, src,
                                  StateTransferRep(replica_id=self.id, view_id=self.view_id,
                                                   crash_vector=self.crash_vector,
                                                   log=list(self.synced),
                                                   sync_point=self.sync_point))

    def _on_state_transfer_rep(self, msg: StateTransferRep) -> None:
        st = self._recovery_state
        if st is None or st["phase"] != "transfer":
            return
        if not rec.check_crash_vector(self.crash_vector, msg.replica_id, msg.crash_vector):
            return
        self.crash_vector = rec.aggregate_crash_vectors([self.crash_vector, msg.crash_vector])
        self._adopt_log(list(msg.log), view_id=msg.view_id)
        self._recovery_state = None
        self.status = Status.NORMAL
        self.last_normal_view = self.view_id

    # ==========================================================================
    # View change (Algorithm 4)
    # ==========================================================================
    def _check_leader(self) -> None:
        if self.alive and self.status == Status.NORMAL and not self.is_leader:
            if self.cluster.scheduler.now - self.last_leader_msg > self.p.heartbeat_timeout:
                self._initiate_view_change(self.view_id + 1)
        if self.alive:
            self.cluster.scheduler.schedule_after(self.p.heartbeat_timeout / 2,
                                                  self._check_leader, tag=f"r{self.id}-fd")

    def _initiate_view_change(self, v: int) -> None:
        if self.status == Status.RECOVERING:
            return
        if self.divergent:
            return  # stale-view denial: a divergent replica never catches up
        if v <= self.view_id and self.status != Status.NORMAL:
            return
        if v <= self.view_id and self.status == Status.NORMAL:
            return  # already in (or past) that view
        self.stats["view_changes"] += 1
        self.status = Status.VIEWCHANGE
        self.view_id = max(v, self.view_id)
        self._vc_replies = {}
        for rid in range(self.n):
            if rid != self.id:
                self.stats["msgs_out"] += 1
                self.cluster.send_replica(self.id, rid,
                                          ViewChangeReq(replica_id=self.id, view_id=self.view_id,
                                                        crash_vector=self.crash_vector))
        self._send_view_change()
        self.cluster.scheduler.schedule_after(self.p.viewchange_resend, self._vc_resend,
                                              tag=f"r{self.id}-vc")

    def _vc_resend(self) -> None:
        if self.alive and self.status == Status.VIEWCHANGE:
            # Escalate: maybe the would-be leader is also dead (SA.3 step 9).
            self._initiate_view_change(self.view_id + 1)

    def _send_view_change(self) -> None:
        vc = ViewChange(replica_id=self.id, view_id=self.view_id,
                        crash_vector=self.crash_vector, log=self.log_view(),
                        sync_point=self.sync_point,
                        last_normal_view=self.last_normal_view)
        target = leader_of_view(self.view_id, self.f)
        if target == self.id:
            self._on_view_change(vc)
        else:
            self.stats["msgs_out"] += 1
            self.cluster.send_replica(self.id, target, vc)

    def _on_view_change_req(self, msg: ViewChangeReq) -> None:
        if self.status == Status.RECOVERING:
            return
        if not rec.check_crash_vector(self.crash_vector, msg.replica_id, msg.crash_vector):
            return
        self.crash_vector = rec.aggregate_crash_vectors([self.crash_vector, msg.crash_vector])
        self.ghash.set_crash_vector(self.crash_vector)
        if msg.view_id > self.view_id:
            self._initiate_view_change(msg.view_id)

    def _on_view_change(self, msg: ViewChange) -> None:
        if self.status == Status.RECOVERING:
            return
        if not rec.check_crash_vector(self.crash_vector, msg.replica_id, msg.crash_vector):
            return
        if msg.replica_id != self.id:
            self.crash_vector = rec.aggregate_crash_vectors([self.crash_vector, msg.crash_vector])
            self.ghash.set_crash_vector(self.crash_vector)
        if msg.view_id > self.view_id:
            self._initiate_view_change(msg.view_id)
        if self.status == Status.NORMAL and msg.view_id == self.view_id and self.is_leader:
            # The sender lags behind (Alg 4 lines 53-57): ship it StartView.
            self.stats["msgs_out"] += 1
            self.cluster.send_replica(self.id, msg.replica_id,
                                      StartView(replica_id=self.id, view_id=self.view_id,
                                                crash_vector=self.crash_vector,
                                                log=list(self.synced)))
            return
        if msg.view_id != self.view_id or leader_of_view(self.view_id, self.f) != self.id:
            return
        # Prune replies that the freshly-aggregated crash-vector exposes as
        # stray (Alg 4 lines 63-66).
        self._vc_replies = {rid: m for rid, m in self._vc_replies.items()
                            if m.crash_vector[rid] >= self.crash_vector[rid] or rid == self.id}
        self._vc_replies[msg.replica_id] = msg
        if self.id not in self._vc_replies and self.status == Status.VIEWCHANGE:
            self._vc_replies[self.id] = ViewChange(
                replica_id=self.id, view_id=self.view_id, crash_vector=self.crash_vector,
                log=self.log_view(), sync_point=self.sync_point,
                last_normal_view=self.last_normal_view)
        if len(self._vc_replies) >= self.f + 1 and self.status == Status.VIEWCHANGE:
            new_log = rec.merge_logs(list(self._vc_replies.values()), self.f,
                                     stats=self.stats)
            self._adopt_log(new_log, view_id=self.view_id)
            self.status = Status.NORMAL
            self.last_normal_view = self.view_id
            self._follower_sp = {}
            for rid in range(self.n):
                if rid != self.id:
                    self.stats["msgs_out"] += 1
                    self.cluster.send_replica(self.id, rid,
                                              StartView(replica_id=self.id, view_id=self.view_id,
                                                        crash_vector=self.crash_vector,
                                                        log=list(new_log)))

    def _on_start_view(self, msg: StartView) -> None:
        if self.status == Status.RECOVERING or self.divergent:
            return
        if not rec.check_crash_vector(self.crash_vector, msg.replica_id, msg.crash_vector):
            return
        self.crash_vector = rec.aggregate_crash_vectors([self.crash_vector, msg.crash_vector])
        if msg.view_id < self.view_id:
            return
        self.view_id = msg.view_id
        self._adopt_log(list(msg.log), view_id=msg.view_id)
        self.status = Status.NORMAL
        self.last_normal_view = self.view_id
        self.last_leader_msg = self.cluster.scheduler.now

    def _adopt_log(self, new_log: list[LogEntry], view_id: int) -> None:
        """Replace local state with `new_log` (StartView / state transfer).

        Leftover unsynced entries are demoted to the late-buffer; the early
        buffer's entrance check is re-seeded from the recovered log tail
        (SA.2 step 9); hashes are rebuilt; the state machine replays.
        """
        self.view_id = max(self.view_id, view_id)
        for e in self.unsynced.values():
            self.dom.late.insert(e.request)
        self.unsynced = {}
        self.pending_mods, self.fetching = {}, set()
        self.synced = [replace_entry(e) for e in new_log]
        self._synced_set = {e.uid for e in self.synced}
        # Rebuild hashes from scratch.
        self.ghash = IncrementalHash(self.crash_vector)
        self.khash = PerKeyHashTable()
        for e in self.synced:
            self._hash_add(e)
        # Seed DOM entrance checks from the recovered log (SA.2 step 9), then
        # re-validate everything still queued in the early-buffer against the
        # new watermark (stale entries are demoted to the late-buffer).
        eb = self.dom.early
        for e in self.synced:
            eb.force_last_released(e.request.with_deadline(e.deadline))
        for req in eb.drain_all():
            if req.uid in self._synced_set:
                continue
            if not eb.insert(req):
                self.dom.late.insert(req)
        # Rebuild execution state (from scratch; commit-point checkpoints are
        # an acceleration -- correctness never depends on them).
        self.sm = self.sm_factory()
        self.results = {}
        for i, e in enumerate(self.synced):
            res = self.sm.execute(e.request.command)
            self.results[e.uid] = res
            e.result = res
        self.executed_point = len(self.synced)
        self.commit_point = min(self.commit_point, len(self.synced))
        # Re-arm replies cache: committed entries can be replayed.
        self.replied = {}
        for e in self.synced:
            self.replied[e.uid] = self._make_fast_reply(
                e, result=e.result if self.is_leader else None)
        # Resume releasing anything still pending in the early-buffer.
        nxt = self.dom.early.peek_deadline()
        if nxt is not None:
            self._schedule_pump(nxt, self.local_time())


def replace_entry(e: LogEntry) -> LogEntry:
    return LogEntry(deadline=e.deadline, client_id=e.client_id,
                    request_id=e.request_id, request=e.request, result=e.result)


@dataclass
class _FetchReq:
    client_id: int
    request_id: int
    view_id: int


@dataclass
class _FetchRep:
    entry: LogEntry
    view_id: int


def _ns(t: float) -> int:
    return int(round(t * 1e9))


def _key_int(k) -> int:
    return k if isinstance(k, int) else abs(hash(k)) & 0x7FFFFFFFFFFFFFFF


__all__ = ["Replica", "ReplicaParams", "StateMachine", "NullApp", "KVStore"]
