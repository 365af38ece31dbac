"""Port of `repro/core/protocol.py` (copied).

NezhaCluster: wires replicas, proxies and clients over the simulated
cloud fabric (paper S5 architecture, Figs 4-5).

Node-id layout on the network: replicas [0, n), proxies [n, n+P), clients
[n+P, n+P+C). In non-proxy mode (Nezha-Non-Proxy, S9.7) the client performs
the proxy's work on its *own* CPU -- reproducing the client-side bottleneck
of Fig 12.

Every message costs CPU on both endpoints (repro_torch.sim.transport.SimFabric),
which is what produces the leader/proxy saturation shapes of Fig 8.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.clock import Clock, SyncService
from repro_torch.core.cluster import CommonConfig, EventCluster, summarize_commits
from repro_torch.core.dom import DomParams
from repro_torch.core.proxy import Client, Proxy
from repro_torch.core.quorum import leader_of_view, n_replicas
from repro_torch.core.replica import NullApp, Replica, ReplicaParams, StateMachine
from repro_torch.sim.transport import CpuParams, SimFabric


@dataclass
class ClusterConfig(CommonConfig):
    """Nezha-specific extension of the shared `CommonConfig` core."""

    n_proxies: int = 1
    co_locate_proxies: bool = False       # Nezha-Non-Proxy mode
    dom: DomParams = field(default_factory=DomParams)
    replica: Optional[ReplicaParams] = None
    qc_at_leader: bool = False      # ablation (Fig 9 "No-QC-Offloading"):
    #   followers reply to the LEADER, which runs the quorum check
    no_dom: bool = False            # ablation (Fig 9 "No-DOM"): proxies send
    #   to the leader only; the leader orders by arrival and multicasts full
    #   request payloads (Multi-Paxos shape with QC offloading)
    client_proxy_lan: float = 0.0   # WAN mode (S9.8): proxies deploy in the
    #   client's zone; client<->proxy hops take this fixed LAN delay instead
    #   of the (WAN) fabric. 0 = disabled.
    # Nezha's replicas/proxies are multithreaded C++ (S9.1: n1-standard-16
    # replicas, n1-standard-32 proxies); calibration in EXPERIMENTS.md.
    replica_cpu: CpuParams = field(default_factory=lambda: CpuParams(threads=2.0))
    proxy_cpu: CpuParams = field(default_factory=lambda: CpuParams(threads=8.0))

    def __post_init__(self):
        if self.no_dom:
            self.dom = DomParams(zero_bound=True)
            self.replica = ReplicaParams(dom=self.dom, commutative=False,
                                         attach_requests_to_mods=True)
        if self.replica is None:
            self.replica = ReplicaParams(dom=self.dom)


class NezhaCluster(EventCluster):
    """Exact event-driven Nezha; implements the unified `Cluster` API.

    `submit`/`submit_at`/`crash`/`relaunch`/`on_commit`/`summary` follow
    repro_torch.core.cluster; the per-client objects (`self.clients`) remain
    available for tests that drive the protocol at a lower level.
    """

    def __init__(self, cfg: ClusterConfig, sm_factory: Callable[[], StateMachine] = NullApp,
                 on_commit: Optional[Callable] = None):
        self.cfg = cfg
        self.f = cfg.f
        self.n = n_replicas(cfg.f)
        self._lqc: dict = {}            # qc_at_leader ablation quorum trackers
        self._last_leader = leader_of_view(0, cfg.f)
        self._on_commit: Optional[Callable[[int, int], None]] = None
        total_nodes = self.n + cfg.n_proxies + cfg.n_clients
        self.fabric = SimFabric(total_nodes, cfg.net, seed=cfg.seed)
        self.scheduler = self.fabric.scheduler
        for i in range(self.n):
            self.fabric.set_cpu(i, cfg.replica_cpu)
        for p in range(cfg.n_proxies):
            self.fabric.set_cpu(self.n + p, cfg.proxy_cpu)
        for c in range(cfg.n_clients):
            self.fabric.set_cpu(self.n + cfg.n_proxies + c, cfg.client_cpu)
        self.rng = np.random.default_rng(cfg.seed + 17)

        # Clocks: replicas + proxies are Huygens-synchronized; clients need
        # no synchronization at all (S5 -- a proxy benefit).
        self.clocks = [Clock(i, cfg.clock, seed=cfg.seed) for i in range(total_nodes)]
        # With cfg.clock.sync_model the service runs measured NTP-style probe
        # rounds through the shared fabric (repro_torch.core.clocksync); node ids
        # 0..n+P-1 are the replica+proxy slots, matching the network's.
        self.sync = SyncService(self.clocks[: self.n + cfg.n_proxies],
                                self.scheduler, cfg.clock,
                                network=self.fabric.network, seed=cfg.seed)

        # Adversarial-fault audit sinks: proxies append per-request
        # deadline-offset samples, lossy replicas record crash-time durability
        # holes; repro_torch.sim.trace reads both when building a CommitTrace.
        self._stamp_audit: list[tuple[int, float]] = []
        self._durability_events: list[dict] = []

        self.replicas = [Replica(i, cfg.f, self, cfg.replica, sm_factory) for i in range(self.n)]
        self.proxies = [Proxy(p, cfg.f, self, cfg.dom) for p in range(cfg.n_proxies)]
        proxy_ids = list(range(cfg.n_proxies))
        self.clients = [
            Client(c, self, proxies=proxy_ids, timeout=cfg.client_timeout)
            for c in range(cfg.n_clients)
        ]
        if on_commit is not None:
            self.on_commit = on_commit   # unified (client_id, request_id) hook

    # -- node-id helpers --------------------------------------------------------
    def _proxy_node(self, proxy_id: int) -> int:
        return self.n + proxy_id

    def _client_node(self, client_id: int) -> int:
        return self.n + self.cfg.n_proxies + client_id

    def clock_of_replica(self, rid: int) -> Clock:
        return self.clocks[rid]

    def clock_of_proxy(self, pid: int) -> Clock:
        # In non-proxy mode the "proxy" runs on the client; Huygens must then
        # cover the client too -- we reuse the proxy-slot clock for it, which
        # is exactly the paper's requirement (clients must synchronize).
        return self.clocks[self._proxy_node(pid % self.cfg.n_proxies)]

    def sigma_of_proxy(self, pid: int) -> float:
        return self.clock_of_proxy(pid).sigma_estimate

    @property
    def msg_count(self) -> int:
        return self.fabric.msg_count

    # -- transport ----------------------------------------------------------------
    def charge_exec(self, rid: int) -> None:
        """Serialize state-machine execution time on the replica's CPU."""
        if self.cfg.exec_cost > 0.0:
            self.fabric._occupy(rid, self.cfg.exec_cost)

    def send_replica(self, src_rid: int, dst_rid: int, msg) -> None:
        r = self.replicas[dst_rid]
        self.fabric.send(src_rid, dst_rid, lambda: r.handle(msg, src_rid))

    def send_proxy_to_replica(self, proxy_id: int, rid: int, req) -> None:
        if self.cfg.no_dom and rid != self.leader_id:
            return  # No-DOM ablation: only the leader receives requests
        r = self.replicas[rid]
        src = self._proxy_src_node(proxy_id)
        self.fabric.send(src, rid, lambda: r.handle(req, self._proxy_node(proxy_id)))

    def _proxy_src_node(self, proxy_id: int) -> int:
        if self.cfg.co_locate_proxies:
            # Proxy work executes on the client node's CPU.
            return self._client_node(proxy_id % self.cfg.n_clients)
        return self._proxy_node(proxy_id)

    def send_to_proxy(self, rid: int, proxy_id: int, msg) -> None:
        p = self.proxies[proxy_id]
        if self.cfg.qc_at_leader:
            # No-QC-Offloading ablation: replies converge on the leader, which
            # aggregates quorums and forwards only the commit to the proxy.
            leader = self.leader_id
            if rid == leader:
                self._leader_qc(msg, rid, proxy_id)
            else:
                self.fabric.send(rid, leader, lambda: self._leader_qc(msg, rid, proxy_id))
            return
        self.fabric.send(rid, self._proxy_src_node(proxy_id), lambda: p.on_reply(msg, rid))

    def _leader_qc(self, msg, rid: int, proxy_id: int) -> None:
        from repro_torch.core.messages import FastReply, SlowReply
        from repro_torch.core.quorum import QuorumTracker

        uid = (msg.client_id, msg.request_id)
        tr = self._lqc.setdefault(uid, QuorumTracker(f=self.f))
        if tr.committed:
            return
        if isinstance(msg, FastReply):
            tr.add_fast(msg.replica_id, msg.view_id, msg.hash, msg.result)
        elif isinstance(msg, SlowReply):
            tr.add_slow(msg.replica_id, msg.view_id)
        result = tr.check_committed()
        if tr.committed:
            p = self.proxies[proxy_id]
            fast = bool(tr.fast_path)
            self.fabric.send(self.leader_id, self._proxy_src_node(proxy_id),
                             lambda: p.on_external_commit(uid, result, fast))

    def report_owd(self, rid: int, proxy_id: int, estimate: float) -> None:
        """OWD estimates are piggybacked on replies (S4): same path; free CPU."""
        p = self.proxies[proxy_id]
        self.fabric.send(rid, self._proxy_src_node(proxy_id),
                         lambda: p.on_owd_estimate(rid, estimate),
                         send_cost=0.0, recv_cost=0.0)

    def send_client_to_proxy(self, client_id: int, proxy_id: int, request_id: int,
                             command, op, keys) -> None:
        p = self.proxies[proxy_id]
        if self.cfg.co_locate_proxies:
            # Nezha-Non-Proxy: the client runs the proxy logic locally.
            self.fabric.local(self._client_node(client_id),
                              lambda: p.submit(client_id, request_id, command, op, keys),
                              cost=self.cfg.client_cpu.recv_cost)
            return
        if self.cfg.client_proxy_lan > 0.0:
            self.scheduler.schedule_after(
                self.cfg.client_proxy_lan,
                lambda: p.submit(client_id, request_id, command, op, keys), tag="lan")
            return
        self.fabric.send(self._client_node(client_id), self._proxy_node(proxy_id),
                         lambda: p.submit(client_id, request_id, command, op, keys))

    def reply_to_client(self, proxy_id: int, client_id: int, uid, result, fast_path: bool) -> None:
        c = self.clients[client_id]
        if self.cfg.co_locate_proxies:
            c.on_reply(uid[1], result, fast_path)
            return
        if self.cfg.client_proxy_lan > 0.0:
            self.scheduler.schedule_after(
                self.cfg.client_proxy_lan,
                lambda: c.on_reply(uid[1], result, fast_path), tag="lan")
            return
        self.fabric.send(self._proxy_node(proxy_id), self._client_node(client_id),
                         lambda: c.on_reply(uid[1], result, fast_path))

    # -- unified Cluster API ---------------------------------------------------
    @property
    def protocol(self) -> str:
        return "nezha-nonproxy" if self.cfg.co_locate_proxies else "nezha"

    def submit(self, client_id: int = 0, request_id: Optional[int] = None,
               keys: tuple = (), op=None, command=None) -> tuple[int, int]:
        """Issue one request through client ``client_id``'s proxy path.

        Request ids are always client-assigned (sequential); an explicit
        ``request_id`` is accepted for interface compatibility and ignored.
        """
        rid = self.clients[client_id].submit(command=command, op=op, keys=keys)
        return (client_id, rid)

    @property
    def on_commit(self) -> Optional[Callable]:
        return self._on_commit

    @on_commit.setter
    def on_commit(self, cb: Optional[Callable]) -> None:
        self._on_commit = cb
        hook = (lambda client, rid: cb(client.id, rid)) if cb else None
        for c in self.clients:
            c.on_commit = hook

    def crash(self, rid: int) -> None:
        self.replicas[rid].crash()

    def relaunch(self, rid: int) -> None:
        self.replicas[rid].relaunch()

    def result_of(self, client_id: int, request_id: int):
        """Committed execution result of a request (None if unknown)."""
        rec = self.clients[client_id].records.get(request_id)
        return rec.result if rec is not None else None

    # -- lifecycle -----------------------------------------------------------------
    def start(self) -> None:
        self.sync.start()
        for r in self.replicas:
            r.start()

    # legacy names, kept as aliases of the unified crash/relaunch
    def crash_replica(self, rid: int) -> None:
        self.crash(rid)

    def relaunch_replica(self, rid: int) -> None:
        self.relaunch(rid)

    # -- introspection ---------------------------------------------------------------
    @property
    def leader_id(self) -> int:
        views = [r.view_id for r in self.replicas if r.alive]
        if not views:
            # Every replica is crashed: report the last known leader rather
            # than raising; summary()/monitoring stay usable during outages.
            return self._last_leader
        self._last_leader = leader_of_view(max(views), self.f)
        return self._last_leader

    @property
    def view_changes(self) -> int:
        """Completed view changes so far (the highest view any replica holds;
        view 0 is the initial configuration)."""
        return max((r.view_id for r in self.replicas), default=0)

    def client_cpu_utilization(self, client_id: int) -> float:
        """CPU utilization of a client node (Fig 12's client-side cost)."""
        return self.fabric.cpu_utilization(self._client_node(client_id))

    def committed_records(self):
        out = []
        for c in self.clients:
            for rec in c.records.values():
                out.append(rec)
        return out

    def summary(self) -> dict:
        recs = self.committed_records()
        fast = sum(1 for r in recs if r.fast_path and np.isfinite(r.commit_time))
        return summarize_commits(
            self.protocol, "event",
            [r.commit_time - r.submit_time for r in recs],
            n_requests=len(recs), n_fast=fast,
            events=self.scheduler.n_dispatched,
            messages=self.fabric.msg_count,
            leader_util=self.fabric.cpu_utilization(self.leader_id),
            view_changes=self.view_changes,
            recovered_entries=sum(r.stats["recovered_entries"]
                                  for r in self.replicas),
            dropped_speculative=sum(r.stats["dropped_speculative"]
                                    for r in self.replicas),
            # Event backend has no epochs; fault exposure counts windows.
            partition_epochs=sum(1 for w in self.net_windows()
                                 if w["kind"] == "partition"),
            gray_link_epochs=sum(1 for w in self.net_windows()
                                 if w["kind"] == "gray"),
        )


__all__ = ["ClusterConfig", "NezhaCluster"]
