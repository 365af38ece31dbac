"""Port of `repro/core/vectorized_cluster.py`: `VectorizedNezhaCluster`,
the fused DOM engine behind the unified `Cluster` API, on torch.

Time advances in **epochs** (``epoch_duration``): each epoch flushes the
pending submissions due by its end through the engine
(`repro_torch.core.engine`), fires ``on_commit`` callbacks in commit order,
and folds commit-triggered resubmissions (closed loop) back into the
pending buffer. On provably fault-free, retry-closed stretches, windows of
K epochs (``epochs_per_dispatch``, snapped to `SCAN_K_BUCKETS`) run the
device body K times with one pull at the end, bit-identical to K single
epochs. The engine runs on ``VectorizedConfig.device``: the card unless
the caller asks for the CPU.

Fault epochs + recovery (paper SA, Alg 3-4): `crash`/`relaunch` (or the
scheduled `crash_at`/`relaunch_at`) record timestamped events; epoch
boundaries split at event times, so the liveness set is constant *within*
an epoch. Leadership is view-based (the leader of view v is v % n); when it
dies, the survivors run the view-change pipeline:

  1. failure detection  -- ``heartbeat_timeout`` after the crash;
  2. ViewChange quorum  -- the f-th order statistic of survivor->leader
     OWDs sampled from the same `CloudNetwork` the data plane uses
     (dropped messages pay ``viewchange_resend``);
  3. MERGE-LOG          -- the vectorized Alg 4 over the engine's
     `ReplicaLogState`; merged speculative entries COMMIT at recovery
     completion, un-merged ones are re-admitted into the next epoch;
  4. StartView quorum   -- commits resume once the leader plus f followers
     are NORMAL in the new view, which floors every release at the
     recovery-completion instant.

While the view change is in flight the data plane is stalled. Uncommitted
attempts follow the client-retry model: re-issued ``client_timeout`` after
they were sent (latency keeps the original submit baseline), up to
``max_retries``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np

from repro_torch.core import spans
from repro_torch.core.clock import ClockParams
from repro_torch.core.cluster import CommonConfig, Cluster, summarize_commits
from repro_torch.core.dom import DomParams
from repro_torch.core.engine import SCAN_K_BUCKETS, DomEngine, PendingBuffer
from repro_torch.core.quorum import leader_of_view, n_replicas
from repro_torch.core.recovery import pack_uids
from repro_torch.sim.network import CloudNetwork
from repro_torch.sim.network import NetworkParams
from repro_torch.sim.transport import CpuParams


@dataclass
class VectorizedConfig(CommonConfig):
    """Vectorized-backend extension of the shared `CommonConfig` core."""

    n_proxies: int = 1
    co_locate_proxies: bool = False     # Nezha-Non-Proxy: skip client<->proxy hops
    client_proxy_lan: float = 0.0       # WAN mode (S9.8): proxies deploy in the
    #   client's zone; client<->proxy hops take this fixed LAN delay instead
    #   of the (WAN) fabric. 0 = disabled. Mirrors ClusterConfig's knob.
    dom: DomParams = field(default_factory=DomParams)
    commutative: bool = True            # S8.2: hash-conflict per key class only
    leader_batch_delay: float = 50e-6   # leader log-mod batching (slow path)
    device: str = "cuda"                # where the epoch body runs: "cuda"
    #   (the DOM kernels) or "cpu" (their plain versions)
    epoch_duration: float = 10e-3       # batching granularity of the data plane
    epochs_per_dispatch: int = 1        # K-epoch window fast path: provably
    #   fault-free, retry-closed windows of up to this many epochs run with
    #   ONE device -> host pull (engine.run_window); window lengths snap to
    #   engine.SCAN_K_BUCKETS. 1 = off. Bit-for-bit identical either way.
    heartbeat_timeout: float = 25e-3    # failure-detector timeout (mirrors
    #   ReplicaParams.heartbeat_timeout; starts the view-change pipeline)
    viewchange_resend: float = 10e-3    # recovery-message retransmit interval
    max_retries: int = 16               # client retry cap per request
    deadline_cap: float = 0.0           # SD.2.4: leader pulls deadlines more
    #   than this past its local arrival back (0 = disabled); bounds holding
    #   delay under bad clock sync at the cost of the fast path.
    sanitize: bool = False              # per-epoch runtime invariant checks
    #   (`repro_torch.core.sanitizer`; also on with REPRO_SANITIZE set)


def config_from_reference(d: dict, **overrides) -> VectorizedConfig:
    """A `VectorizedConfig` from ``dataclasses.asdict`` of the reference
    package's `VectorizedConfig` (plain nested dicts, so no reference type
    crosses over). The reference's ``tier`` names a compute tier the port
    does not have and is dropped; ``overrides`` (e.g. ``device="cpu"``)
    apply last."""
    nested = {"net": NetworkParams, "clock": ClockParams,
              "client_cpu": CpuParams, "dom": DomParams}
    names = {f.name for f in fields(VectorizedConfig)}
    kw = {}
    for key, value in d.items():
        if key not in names:
            continue
        kw[key] = nested[key](**value) if key in nested else value
    kw.update(overrides)
    return VectorizedConfig(**kw)


@dataclass
class _ViewChangeInProgress:
    view: int           # target view
    leader: int         # leader_of_view(view) -- alive when the VC started
    t_start: float      # when the previous leader was lost (or the VC retimed)
    t_done: float       # StartView-quorum completion time (inf below quorum)


class VectorizedNezhaCluster(Cluster):
    """Nezha's steady-state data plane as a fused, epoch-driven engine."""

    backend = "vectorized"
    supports_closed_loop = True

    def __init__(self, cfg: VectorizedConfig, sm_factory=None):
        # sm_factory accepted for constructor compatibility; the vectorized
        # backend models the null application only (no command execution).
        if cfg.epoch_duration <= 0:
            raise ValueError("epoch_duration must be > 0")
        self.cfg = cfg
        self.f = cfg.f
        self.n = n_replicas(cfg.f)
        total = self.n + cfg.n_proxies + cfg.n_clients
        self.net = CloudNetwork(total, cfg.net, seed=cfg.seed)
        self.engine = DomEngine(cfg, self.net, self.n)
        self._alive = np.ones(self.n, dtype=bool)
        self._now = 0.0
        self._next_rid = [0] * cfg.n_clients
        self._pending = PendingBuffer()
        # Stable key->class interning: commutativity classes must reproduce
        # across runs/processes (builtin hash() varies with PYTHONHASHSEED).
        self._key_classes: dict[tuple, int] = {}
        # Timestamped fault events, applied at epoch boundaries. Payloads:
        #   ("alive", rid, alive_after)            crash/relaunch
        #   ("clock", role, idx, mu, sigma)        clock fault/clear
        #   ("net", NetworkParams)                 network-regime shift
        #   ("partition", minority_rids)           Partition (cut minority off)
        #   ("heal",)                              Heal
        #   ("gray", pairs, mu, sigma, drop)       GrayLink/GrayClear over
        #                                          [(proxy_ids, replica_ids)]
        #   ("stamp-bias", proxy_id, bias)         SkewedStamper
        #   ("lossy", rid)                         LossyAcker
        #   ("sync-outage", flag)                  SyncOutage / SyncRestore
        #   ("sync-bias", obs, peers, bias)        SyncBias (probe-path bias
        #                                          over daemon node ids)
        #   ("clock-leap", nodes, delta)           ClockLeap (a TRUE step)
        self._fault_events: list[tuple[float, tuple]] = []
        # Adversarial-network exposure bookkeeping: closed fault windows for
        # the trace checkers (check_partition_liveness) + per-epoch counters
        # for the machine-readable summary.
        self._net_windows: list[dict] = []
        self._partition_open: Optional[dict] = None
        self._gray_t0: Optional[float] = None
        self._partition_epochs = 0
        self._gray_epochs = 0
        self._trace_stamps: list[tuple] = []    # (pids, deadline - stamp)
        self._view = 0
        self._vc: Optional[_ViewChangeInProgress] = None
        self._release_floor = 0.0
        self._last_leader: int = leader_of_view(0, cfg.f)
        self.epoch_leaders: list[int] = []   # -1 marks a total-outage epoch
        self.view_change_events: list[dict] = []   # completed recoveries
        # accumulated results across epochs
        self._latencies: list[np.ndarray] = []
        self._trace_commits: list[tuple] = []   # (t, cid, rid, fast, recovered)
        self._n_requests = 0
        self._n_fast = 0
        self._batches = 0
        self._epochs = 0
        self._recovered_entries = 0
        self._dropped_speculative = 0

    @property
    def protocol(self) -> str:
        return "nezha-nonproxy" if self.cfg.co_locate_proxies else "nezha"

    # -- Cluster API -------------------------------------------------------------
    @property
    def now(self) -> float:
        return self._now

    @property
    def _reachable(self) -> np.ndarray:
        """Replicas that are alive AND not cut off by a partition: the set
        that can lead, vote in view changes, and sync the log."""
        return self._alive & ~self.engine.unreachable

    @property
    def leader_id(self) -> int:
        """Current (or elect) leader: the leader of the first view >= the
        current one whose leader is alive and reachable (last known during
        total outage)."""
        ok = self._reachable
        if not ok.any():
            return self._last_leader
        v = self._view
        while not ok[leader_of_view(v, self.f)]:
            v += 1
        return leader_of_view(v, self.f)

    def _key_class(self, keys: tuple) -> int:
        if not keys:
            return -1               # keyless requests share the global class
        kt = tuple(keys)
        cls = self._key_classes.get(kt)
        if cls is None:
            cls = len(self._key_classes)
            self._key_classes[kt] = cls
        return cls

    def submit(self, client_id: int = 0, request_id: Optional[int] = None,
               keys: tuple = (), op=None, command=None) -> tuple[int, int]:
        return self.submit_at(self._now, client_id, keys=keys, op=op,
                              command=command, request_id=request_id)

    def submit_at(self, t: float, client_id: int = 0, keys: tuple = (),
                  op=None, command=None, request_id: Optional[int] = None,
                  deadline: float = 0.0) -> tuple[int, int]:
        # Explicit request ids come from a routing layer (nezha-sharded)
        # that owns the global uid space: honor them and keep the internal
        # counter ahead so mixed explicit/implicit submissions never
        # collide. ``deadline`` > 0 pre-stamps the entry's DOM deadline
        # (the sharded MultiOp global slot); 0.0 = proxy stamps normally.
        if request_id is None:
            rid = self._next_rid[client_id]
            self._next_rid[client_id] = rid + 1
        else:
            rid = int(request_id)
            self._next_rid[client_id] = max(self._next_rid[client_id],
                                            rid + 1)
        self._pending.append(t, client_id, rid, self._key_class(keys),
                             dl=float(deadline))
        self._n_requests += 1          # counted once; retries are not requests
        return (client_id, rid)

    # -- fault events ------------------------------------------------------------
    def crash(self, rid: int) -> None:
        self.crash_at(self._now, rid)

    def relaunch(self, rid: int) -> None:
        self.relaunch_at(self._now, rid)

    def crash_at(self, t: float, rid: int) -> None:
        """Schedule replica ``rid`` to crash at sim time ``t`` (>= now)."""
        self._add_fault(t, rid, alive=False)

    def relaunch_at(self, t: float, rid: int) -> None:
        self._add_fault(t, rid, alive=True)

    def _add_fault(self, t: float, rid: int, alive: bool) -> None:
        if not (0 <= rid < self.n):
            raise ValueError(f"replica id {rid} out of range [0, {self.n})")
        self._add_event(t, ("alive", int(rid), alive))

    def _add_event(self, t: float, payload: tuple) -> None:
        # insort_right keeps same-time events in insertion order, as the old
        # stable whole-list re-sort did, at O(log n) compares + one shift.
        bisect.insort(self._fault_events, (float(t), payload),
                      key=lambda e: e[0])
        self._apply_faults(self._now)

    def _apply_faults(self, up_to: float) -> None:
        while self._fault_events and self._fault_events[0][0] <= up_to:
            t, payload = self._fault_events.pop(0)
            if payload[0] == "alive":
                _, rid, alive_after = payload
                was_alive = bool(self._alive[rid])
                self._alive[rid] = alive_after
                if was_alive and not alive_after:
                    # diskless crash: the replica's log state is gone (SA)
                    self.engine.logs.on_crash(rid)
            elif payload[0] == "clock":
                _, role, idx, mu, sigma = payload
                self.engine.set_clock_fault(role, idx, mu, sigma)
            elif payload[0] == "net":
                self.net.set_params(payload[1])
            elif payload[0] == "partition":
                minority = list(payload[1])
                self.engine.set_partition(minority)
                self._partition_open = {
                    "t0": t, "minority": minority,
                    "snap": self.engine.logs.sync_point[minority].copy()}
            elif payload[0] == "heal":
                if self._partition_open is not None:
                    # minority progress measured BEFORE the heal lets them
                    # catch up: durable log growth on the cut-off side
                    self._net_windows.append(
                        self._close_partition_window(t))
                    self._partition_open = None
                self.engine.clear_partition()
            elif payload[0] == "gray":
                _, pairs, mu, sigma, drop = payload
                active = mu > 0.0 or sigma > 0.0 or drop > 0.0
                for pids, rids in pairs:
                    if active:
                        self.engine.set_gray(pids, rids, mu, sigma, drop)
                    else:
                        self.engine.clear_gray(pids, rids)
                if self.engine.gray_active:
                    if self._gray_t0 is None:
                        self._gray_t0 = t
                elif self._gray_t0 is not None:
                    self._net_windows.append(
                        {"kind": "gray", "t0": self._gray_t0, "t1": t})
                    self._gray_t0 = None
            elif payload[0] == "stamp-bias":
                self.engine.set_stamp_bias(payload[1], payload[2])
            elif payload[0] == "lossy":
                self.engine.logs.set_lossy(payload[1])
            elif payload[0] == "sync-outage":
                self.engine.clocksync.set_outage(payload[1])
            elif payload[0] == "sync-bias":
                _, obs, prs, bias = payload
                self.engine.clocksync.set_probe_bias(obs, prs, bias)
            elif payload[0] == "clock-leap":
                self.engine.clocksync.step(payload[1], payload[2])

    def _close_partition_window(self, t1: float) -> dict:
        po = self._partition_open
        prog = int(np.maximum(
            self.engine.logs.sync_point[po["minority"]] - po["snap"],
            0).sum())
        return {"kind": "partition", "t0": po["t0"], "t1": t1,
                "minority": po["minority"], "minority_progress": prog}

    def net_windows(self) -> list[dict]:
        """Adversarial-network fault windows for the trace checkers; a
        window still open when called closes at the current sim time."""
        out = list(self._net_windows)
        if self._partition_open is not None:
            out.append(self._close_partition_window(self._now))
        if self._gray_t0 is not None:
            out.append({"kind": "gray", "t0": self._gray_t0, "t1": self._now})
        return out

    def _next_fault_time(self) -> float:
        return self._fault_events[0][0] if self._fault_events else np.inf

    def schedule_fault(self, event) -> bool:
        """Scenario fault-event application (see `Cluster.schedule_fault`).

        Every event kind becomes an epoch-boundary event: the epoch loop
        splits at its timestamp, so liveness, clock-error state, and the
        network regime are constant within an epoch and change across them.
        """
        kind = getattr(event, "kind", None)
        if kind in ("crash", "relaunch"):
            self._add_fault(event.t, event.rid, alive=kind == "relaunch")
            return True
        if kind in ("clock-fault", "clock-clear"):
            mu, sigma = ((event.mu, event.sigma) if kind == "clock-fault"
                         else (0.0, 0.0))
            for role, idx in event.targets(self.n, self.cfg.n_proxies):
                self._add_event(event.t, ("clock", role, idx, mu, sigma))
            return True
        if kind == "net-shift":
            self._add_event(event.t, ("net", event.params))
            return True
        if kind == "partition":
            self._add_event(event.t, ("partition", tuple(event.minority())))
            return True
        if kind == "heal":
            self._add_event(event.t, ("heal",))
            return True
        if kind in ("gray-link", "gray-clear"):
            # Resolve src/dst selectors (fail at schedule time, not mid-run)
            # to directed (proxy, replica) pair sets: the vectorized data
            # plane's only per-pair paths are proxy<->replica legs.
            from repro_torch.sim.scenario import _link_nodes

            r_src, p_src = _link_nodes(event.src, self.n, self.cfg.n_proxies)
            r_dst, p_dst = _link_nodes(event.dst, self.n, self.cfg.n_proxies)
            pairs = []
            if p_src and r_dst:
                pairs.append((tuple(p_src), tuple(r_dst)))
            if p_dst and r_src and (p_dst, r_src) != (p_src, r_dst):
                pairs.append((tuple(p_dst), tuple(r_src)))
            if not pairs:
                return False
            mu, sigma, drop = ((event.delay_mu, event.delay_sigma,
                                event.drop_prob) if kind == "gray-link"
                               else (0.0, 0.0, 0.0))
            self._add_event(event.t, ("gray", pairs, mu, sigma, drop))
            return True
        if kind == "skewed-stamper":
            self._add_event(event.t, ("stamp-bias", int(event.proxy_id),
                                      float(event.bias)))
            return True
        if kind == "lossy-acker":
            if not (0 <= event.rid < self.n):
                raise ValueError(
                    f"replica id {event.rid} out of range [0, {self.n})")
            self._add_event(event.t, ("lossy", int(event.rid)))
            return True
        if kind in ("sync-outage", "sync-restore", "sync-bias", "clock-leap"):
            if self.engine.clocksync is None:
                return False        # no modeled sync loop to degrade
            if kind in ("sync-outage", "sync-restore"):
                self._add_event(event.t,
                                ("sync-outage", kind == "sync-outage"))
            elif kind == "sync-bias":
                obs = self._sync_nodes(event.src)
                prs = self._sync_nodes(event.dst)
                self._add_event(event.t,
                                ("sync-bias", obs, prs, float(event.bias)))
            else:
                nodes = self._sync_nodes(event.who)
                self._add_event(event.t,
                                ("clock-leap", nodes, float(event.delta)))
            return True
        return False

    def _sync_nodes(self, selector) -> tuple[int, ...]:
        """Resolve a clock-target selector to sync-daemon node ids
        (replicas 0..R-1, proxies R..R+P-1); fails at schedule time."""
        from repro_torch.sim.scenario import _clock_targets

        if selector == "all":
            return tuple(range(self.n + self.cfg.n_proxies))
        out = []
        for role, idx in _clock_targets(selector, self.n, self.cfg.n_proxies):
            out.append(idx if role == "replica" else self.n + idx)
        return tuple(out)

    # -- view changes (the recovery pipeline) ------------------------------------
    def _viable_view(self, from_view: int) -> int:
        """Smallest view >= from_view whose leader is alive and reachable
        (a partitioned-away leader cannot win a majority's votes)."""
        ok = self._reachable
        v = from_view
        while not ok[leader_of_view(v, self.f)]:
            v += 1
        return v

    def _sample_delivered_owds(self, srcs: np.ndarray,
                               dsts: np.ndarray) -> np.ndarray:
        """Per-pair OWDs until delivery: dropped recovery messages are
        retransmitted every ``viewchange_resend`` (same fabric statistics).
        Bounded at 64 rounds so a pathological drop_prob ~= 1 regime (where
        nothing can ever be delivered) degrades to a huge-but-finite delay
        instead of spinning the epoch loop forever."""
        srcs = np.asarray(srcs)
        dsts = np.asarray(dsts)
        owd, dropped = self.net.sample_owd_pairs(srcs, dsts)
        penalty = np.zeros(owd.size)
        for _ in range(64):
            if not dropped.any():
                break
            idx = np.flatnonzero(dropped)
            penalty[idx] += self.cfg.viewchange_resend
            owd2, d2 = self.net.sample_owd_pairs(srcs[idx], dsts[idx])
            owd[idx] = owd2
            dropped[:] = False
            dropped[idx] = d2
        return owd + penalty

    def _start_view_change(self, now: float, view: int) -> _ViewChangeInProgress:
        """Time the recovery pipeline from sampled network work.

        detection (heartbeat_timeout) -> ViewChange quorum at the new leader
        (f-th order statistic of survivor->leader OWDs beyond its own
        message) -> MERGE-LOG + StartView batching (leader_batch_delay) ->
        StartView quorum (f-th order statistic of leader->survivor OWDs:
        commits need the leader plus f NORMAL followers). Below the f+1
        quorum the view change cannot complete: t_done = inf until a
        relaunch restores it.
        """
        leader = leader_of_view(view, self.f)
        others = np.flatnonzero(self._reachable)
        others = others[others != leader]
        if others.size < self.f:        # < f+1 alive including the leader
            t_done = np.inf
        else:
            t_detect = now + self.cfg.heartbeat_timeout
            vc_in = self._sample_delivered_owds(
                others, np.full(others.size, leader))
            t_quorum = t_detect + float(np.partition(vc_in, self.f - 1)[self.f - 1])
            sv_out = self._sample_delivered_owds(
                np.full(others.size, leader), others)
            t_done = t_quorum + self.cfg.leader_batch_delay \
                + float(np.partition(sv_out, self.f - 1)[self.f - 1])
        return _ViewChangeInProgress(view=view, leader=leader,
                                     t_start=now, t_done=t_done)

    def _update_view(self, now: float) -> None:
        """Start, escalate, stall, retime, or complete the view change.

        Reachability counts like liveness: a partitioned-away leader is
        failed from the majority's point of view (heartbeats stop arriving)
        and partitioned-away replicas cannot vote, so the quorum is over
        the alive AND reachable set."""
        ok = self._reachable
        if not ok.any():
            self._vc = None     # nobody left to run a view change
            return
        while True:
            if self._vc is None:
                if ok[leader_of_view(self._view, self.f)]:
                    return
                self._vc = self._start_view_change(
                    now, self._viable_view(self._view + 1))
                return
            vc = self._vc
            if not ok[vc.leader]:
                # the new leader died (or fell behind a partition)
                # mid-recovery: escalate past it (the survivors'
                # view-change timers fire afresh)
                self._vc = self._start_view_change(
                    now, self._viable_view(vc.view + 1))
                return
            if np.count_nonzero(ok) < self.f + 1:
                vc.t_done = np.inf          # quorum lost mid-recovery: stall
                return
            if not np.isfinite(vc.t_done):
                # quorum restored (relaunch): the returning replica must be
                # detected and integrated -- retime the pipeline from now
                self._vc = self._start_view_change(now, vc.view)
                return
            if now >= vc.t_done:
                self._complete_view_change()
                continue    # the next view's leader may be down already
            return

    def _complete_view_change(self) -> None:
        """StartView: run the vectorized MERGE-LOG and enter the new view.

        Merged speculative entries commit as part of the new view's initial
        log -- delivered to their clients over sampled reply paths, removed
        from the pending retries. Un-merged ones are dropped from the logs
        and re-admitted into the next epoch's DOM stage (proxy retransmit
        at StartView).
        """
        vc = self._vc
        t_rec = vc.t_done
        spans.count("viewchanges_done")
        # Only reachable survivors take part in MERGE-LOG and install the
        # merged log at StartView; a partitioned-away replica stays on its
        # frozen state until the heal lets it catch up.
        res = self.engine.logs.view_change(vc.view, self._reachable)
        rec, dropped = res["recovered"], res["dropped"]
        self._view = vc.view
        self._last_leader = vc.leader
        self._release_floor = max(self._release_floor, t_rec)
        self._vc = None
        self._recovered_entries += int(rec["cid"].size)
        self._dropped_speculative += int(dropped["cid"].size)
        self.view_change_events.append({
            "view": vc.view, "leader": vc.leader, "t_start": vc.t_start,
            "t_done": t_rec, "recovered": int(rec["cid"].size),
            "dropped": int(dropped["cid"].size),
        })
        if dropped["cid"].size:
            # proxies retransmit un-merged entries at StartView: their
            # pending retry is pulled up to the recovery-completion instant
            self._pending.reschedule_uids(dropped["cid"], dropped["rid"], t_rec)
        if rec["cid"].size:
            self._deliver_recovered(rec, vc.leader, t_rec)

    def _deliver_recovered(self, rec: dict, leader: int, t_rec: float) -> None:
        cfg = self.cfg
        k = int(rec["cid"].size)
        pids = rec["cid"] % cfg.n_proxies
        pnodes = self.engine.proxy_nodes(pids)
        leg1 = self._sample_delivered_owds(np.full(k, leader), pnodes)
        if cfg.co_locate_proxies:
            leg2 = np.zeros(k)
        elif cfg.client_proxy_lan > 0.0:
            leg2 = np.full(k, cfg.client_proxy_lan)
        else:
            cnodes = self.engine.client_nodes(rec["cid"])
            leg2 = self._sample_delivered_owds(pnodes, cnodes)
        commit_at = t_rec + leg1 + leg2
        # the clients stop retrying: their request is committed (slow path)
        rows = self._pending.pop_uids(rec["cid"], rec["rid"])
        if rows.size == 0:      # pragma: no cover - spec entries are pending
            found = np.zeros(k, bool)
        else:
            keys_p = pack_uids(rows["cid"], rows["rid"])
            order = np.argsort(keys_p)
            keys_r = pack_uids(rec["cid"], rec["rid"])
            pos = np.searchsorted(keys_p[order], keys_r)
            pos_c = np.minimum(pos, keys_p.size - 1)
            found = keys_p[order][pos_c] == keys_r
            lat = commit_at[found] - rows["t0"][order][pos[found]]
            self._latencies.append(lat)
        self._trace_commits.append((
            commit_at[found], rec["cid"][found], rec["rid"][found],
            np.zeros(int(found.sum()), bool), np.ones(int(found.sum()), bool)))
        if self.on_commit is not None and found.any():
            idx = np.flatnonzero(found)
            idx = idx[np.argsort(commit_at[idx], kind="stable")]
            t_save = self._now
            for i in idx:
                self._now = float(commit_at[i])
                self.on_commit(int(rec["cid"][i]), int(rec["rid"][i]))
            self._now = t_save

    # -- the epoch loop ----------------------------------------------------------
    def run_for(self, duration: float) -> None:
        horizon = self._now + duration
        ep = self.cfg.epoch_duration
        while self._now < horizon:
            self._apply_faults(self._now)
            # _apply_faults consumed every event at or before now, so both
            # candidates are strictly ahead and the loop always advances.
            with spans.span("viewchange"):
                self._update_view(self._now)
            candidates = [horizon, self._now + ep, self._next_fault_time()]
            if self._vc is not None and np.isfinite(self._vc.t_done):
                candidates.append(self._vc.t_done)
            epoch_end = min(candidates)
            # Modeled sync: clock truth advances to the epoch
            # boundary and any due probe round queues BEFORE the epoch runs
            # -- so every run folds the round at the identical epoch slot.
            self.engine.advance_sync(epoch_end)
            if self._vc is not None and np.isfinite(self._vc.t_done):
                # recovery stall: replicas are in VIEWCHANGE status; pending
                # requests wait in the proxies/early buffers until StartView
                self.epoch_leaders.append(self._vc.leader)
            elif self._vc is not None or not self._alive.any():
                # total outage, or a view change that CANNOT complete (below
                # the f+1 quorum): the cluster is unresponsive indefinitely,
                # so clients time out and retry until abandonment -- same
                # accounting as the event backend, no silently-held requests
                while True:
                    due = self._pending.pop_due(epoch_end)
                    if due.size == 0:
                        break
                    self._batches += 1
                    with spans.span("absorb"):
                        self._retry(due)
                self.epoch_leaders.append(
                    self._vc.leader if self._vc is not None else -1)
            else:
                k_window = self._window_len(horizon)
                if k_window:
                    self._run_window(k_window)
                    continue
                leader = leader_of_view(self._view, self.f)
                batches = self._batches
                self._run_epoch_batches(epoch_end, leader,
                                        self._deaths_at(epoch_end))
                if self._batches > batches:
                    spans.count("epochs_single")
                self._last_leader = leader
                self.epoch_leaders.append(leader)
            if self.engine.unreachable.any():
                self._partition_epochs += 1
            if self.engine.gray_active:
                self._gray_epochs += 1
            self._epochs += 1
            self._now = epoch_end

    # -- the K-epoch window fast path --------------------------------------------
    def _window_len(self, horizon: float) -> int:
        """Largest SCAN_K_BUCKETS window the fast path may dispatch now.

        0 when the window path is off or ineligible.  A window of K epochs
        is eligible only when the device program can be segment-free: no
        view change in flight (caller's branch), synced clocks, no
        callbacks (closed-loop resubmission re-times epochs), every epoch a
        full ``epoch_duration`` inside the horizon, no fault event at or
        before the window's end (liveness, clocks, and the network regime
        stay constant; no ``dies_at`` cut-offs), and the retry-closure
        guarantee: the window ends strictly before the earliest pending
        request could produce a due retry (`t >= min_time + client_timeout`),
        so each epoch is exactly one generation and no in-window attempt's
        retry falls due in-window.  Epoch boundaries accumulate one
        ``epoch_duration`` at a time, exactly like the sequential loop, so
        timing is bit-identical.
        """
        cfg = self.cfg
        k_max = int(getattr(cfg, "epochs_per_dispatch", 1))
        if k_max < min(SCAN_K_BUCKETS) \
                or self.on_commit is not None or self.engine.clocks_faulty \
                or self.engine.pairs_faulty or self.engine.stampers_biased \
                or self.engine.sync_active \
                or self._pending.has_prestamped():
            return 0
        t_min = self._pending.min_time()
        retry_closed = t_min + cfg.client_timeout
        fault = self._next_fault_time()
        for k in sorted(SCAN_K_BUCKETS, reverse=True):
            if k > k_max:
                continue
            end = self._now
            for _ in range(k):
                end = end + cfg.epoch_duration
            if end <= horizon and fault > end and end < retry_closed \
                    and t_min < end:
                return k
        return 0

    def _run_window(self, k: int) -> None:
        """Dispatch K consecutive fault-free epochs through the engine's
        `run_window` (the body K times on the device, one pull), then do the
        per-epoch client bookkeeping in epoch order -- identical results to
        K sequential `_run_epoch_batches` iterations (retry closure makes
        the up-front `pop_due` sequence equal to the interleaved one)."""
        ep = self.cfg.epoch_duration
        leader = leader_of_view(self._view, self.f)
        ends = []
        e = self._now
        for _ in range(k):
            e = e + ep
            ends.append(e)
        dues = [self._pending.pop_due(t) for t in ends]
        states = self.engine.run_window(dues, self._alive, leader,
                                              self._release_floor)
        if spans.on():
            spans.count("epochs_window",
                        sum(s is not None for s in states))
        for due, s in zip(dues, states):
            if s is not None:
                self._absorb_epoch_state(due, s)
            self._last_leader = leader
            self.epoch_leaders.append(leader)
            self._epochs += 1
        self._now = ends[-1]

    def _deaths_at(self, epoch_end: float) -> Optional[np.ndarray]:
        """Death instants of replicas crashing exactly when this epoch ends:
        their in-flight messages are cut off mid-epoch (crash fidelity --
        this is what strands speculative entries on the survivors)."""
        dies_at = None
        for t, payload in self._fault_events:
            if t > epoch_end:
                break
            if payload[0] == "alive" and not payload[2]:
                if dies_at is None:
                    dies_at = np.full(self.n, np.inf)
                dies_at[payload[1]] = min(dies_at[payload[1]], t)
        return dies_at

    def _retry(self, failed: np.ndarray) -> None:
        """Client retry model: an undelivered attempt (drop, outage, lost
        quorum) is re-issued ``client_timeout`` after it was sent, keeping
        its original t0 for latency. Attempts past ``max_retries`` are
        abandoned (one inf latency records the permanently failed request)."""
        failed = failed.copy()
        failed["tries"] += 1
        given_up = failed["tries"] > self.cfg.max_retries
        if given_up.any():
            self._latencies.append(np.full(int(given_up.sum()), np.inf))
            spans.count("given_up", int(given_up.sum()))
            # abandoned requests also leave the speculative logs: a later
            # recovery must not resurrect a request its client gave up on
            self.engine.logs.drop_uids(failed["cid"][given_up],
                                       failed["rid"][given_up])
            failed = failed[~given_up]
        if spans.on():
            # re-issues by their attempts so far
            for k, n in enumerate(np.bincount(failed["tries"])):
                if n:
                    spans.count(f"retry_gen_{k}", int(n))
        failed["t"] += self.cfg.client_timeout
        self._pending.extend(failed)

    def _absorb_epoch_state(self, due: np.ndarray, s) -> None:
        """Per-epoch client bookkeeping shared by the sequential and K-epoch
        window paths: stamp audit, latency and
        fast-path accounting, the commit trace, retries, and closed-loop
        callbacks. Identical order of operations on every path (bit parity).
        """
        with spans.span("absorb"):
            self._batches += 1
            # stamp audit for check_stamp_bias: per-message (proxy id,
            # deadline - true stamp instant) = bound (+ bias + clock error);
            # attempts whose client leg was dropped never got stamped
            fin = np.isfinite(s.stamp)
            self._trace_stamps.append(
                (s.cid[fin] % self.cfg.n_proxies,
                 s.deadlines[fin] - s.stamp[fin]))
            self._latencies.append(s.latency[s.delivered])
            self._n_fast += int(np.sum(s.fast & s.delivered))
            if s.delivered.any():
                idx = np.flatnonzero(s.delivered)
                self._trace_commits.append((
                    s.commit_at_client[idx], s.cid[idx], s.rid[idx],
                    (s.fast & s.delivered)[idx], np.zeros(idx.size, bool)))
            if not s.delivered.all():
                self._retry(due[~s.delivered])
            if self.on_commit is not None and s.delivered.any():
                idx = np.flatnonzero(s.delivered)
                idx = idx[np.argsort(s.commit_at_client[idx], kind="stable")]
                t_save = self._now
                for i in idx:
                    # callbacks observe the commit's client-side time, so a
                    # closed-loop resubmission is stamped when the reply lands
                    self._now = float(s.commit_at_client[i])
                    self.on_commit(int(s.cid[i]), int(s.rid[i]))
                self._now = t_save

    def _run_epoch_batches(self, epoch_end: float, leader: int,
                           dies_at: Optional[np.ndarray] = None) -> None:
        """Flush pending work due by ``epoch_end``; commit-triggered
        resubmissions landing inside the epoch run as further generations."""
        while True:
            due = self._pending.pop_due(epoch_end)
            if due.size == 0:
                return
            s = self.engine.run_epoch(due, self._alive, leader,
                                      self._release_floor, dies_at=dies_at)
            self._absorb_epoch_state(due, s)

    @property
    def view_changes(self) -> int:
        """Highest view entered (view 0 is the initial configuration),
        counting an in-flight view change's target like the event backend's
        replicas count an initiated one."""
        return self._vc.view if self._vc is not None else self._view

    def summary(self) -> dict:
        lat = (np.concatenate(self._latencies) if self._latencies
               else np.zeros(0))
        return summarize_commits(
            self.protocol, "vectorized", lat,
            n_requests=self._n_requests, n_fast=self._n_fast,
            batches=self._batches, epochs=self._epochs,
            tier=self.engine.tier_name, view_changes=self.view_changes,
            recovered_entries=self._recovered_entries,
            dropped_speculative=self._dropped_speculative,
            partition_epochs=self._partition_epochs,
            gray_link_epochs=self._gray_epochs,
        )


__all__ = ["VectorizedConfig", "VectorizedNezhaCluster", "config_from_reference"]
