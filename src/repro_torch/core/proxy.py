"""Port of `repro/core/proxy.py` (copied).

Stateless Nezha proxy (paper S5, Algorithm 2) and the client.

The proxy is the DOM sender: it stamps <s, l> onto requests, multicasts to
all replicas, aggregates replies with a QuorumTracker, and answers the
client once a quorum commits. All its state is soft (in-flight trackers);
losing a proxy only looks like packet loss to clients (S6.5).

Nezha-Non-Proxy is the same object co-located with the client (zero-delay
client<->proxy path) -- the cluster wires that.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.dom import DomParams, DomSender
from repro_torch.core.messages import FastReply, Request, SlowReply
from repro_torch.core.quorum import QuorumTracker, n_replicas


class Proxy:
    def __init__(self, proxy_id: int, f: int, cluster, dom_params: Optional[DomParams] = None):
        self.id = proxy_id
        self.f = f
        self.n = n_replicas(f)
        self.cluster = cluster
        self.dom = DomSender(self.n, dom_params)
        self.trackers: dict[tuple[int, int], QuorumTracker] = {}
        self.origin: dict[tuple[int, int], int] = {}   # uid -> client node
        self.stamp_bias = 0.0   # SkewedStamper fault: deterministic shift
        #   added to every stamp (and therefore deadline) this proxy issues.
        self.stats = {"multicasts": 0, "replies_in": 0, "committed": 0,
                      "fast_committed": 0}

    @property
    def clock(self):
        return self.cluster.clock_of_proxy(self.id)

    # -- client-facing ---------------------------------------------------------
    def submit(self, client_id: int, request_id: int, command, op, keys) -> None:
        now_local = self.clock.read_monotonic(self.cluster.scheduler.now)
        s, l = self.dom.stamp(now_local)
        if self.stamp_bias:
            s += self.stamp_bias     # SkewedStamper: the carried stamp lies
        req = Request(client_id=client_id, request_id=request_id, command=command,
                      send_time=s, latency_bound=l, deadline=s + l,
                      proxy_id=self.id, op=op, keys=tuple(keys))
        audit = getattr(self.cluster, "_stamp_audit", None)
        if audit is not None:
            # deadline minus the honest local send-time read: the per-proxy
            # deadline-offset sample `check_stamp_bias` aggregates.
            audit.append((self.id, req.deadline - now_local))
        uid = req.uid
        self.origin[uid] = client_id
        if uid not in self.trackers or self.trackers[uid].committed:
            self.trackers[uid] = QuorumTracker(f=self.f)
        self.stats["multicasts"] += 1
        for rid in range(self.n):
            self.cluster.send_proxy_to_replica(self.id, rid, req)

    # -- replica-facing ----------------------------------------------------------
    def on_reply(self, msg, replica_id: int) -> None:
        self.stats["replies_in"] += 1
        uid = (msg.client_id, msg.request_id)
        tr = self.trackers.get(uid)
        if tr is None or tr.committed:
            return
        if isinstance(msg, FastReply):
            tr.add_fast(msg.replica_id, msg.view_id, msg.hash, msg.result)
        elif isinstance(msg, SlowReply):
            tr.add_slow(msg.replica_id, msg.view_id)
        result = tr.check_committed()
        if tr.committed:
            self.stats["committed"] += 1
            if tr.fast_path:
                self.stats["fast_committed"] += 1
            self.cluster.reply_to_client(self.id, self.origin[uid], uid, result,
                                         fast_path=bool(tr.fast_path))

    def on_owd_estimate(self, replica_id: int, estimate: float) -> None:
        self.dom.on_estimate(replica_id, estimate)

    def on_external_commit(self, uid, result, fast_path: bool) -> None:
        """qc_at_leader mode: the leader already established the quorum."""
        tr = self.trackers.get(uid)
        if tr is not None and tr.committed:
            return
        if tr is not None:
            tr.committed, tr.fast_path = True, fast_path
        if uid in self.origin:
            self.stats["committed"] += 1
            if fast_path:
                self.stats["fast_committed"] += 1
            self.cluster.reply_to_client(self.id, self.origin[uid], uid, result,
                                         fast_path=fast_path)

    def forget(self, uid) -> None:
        self.trackers.pop(uid, None)
        self.origin.pop(uid, None)


@dataclass
class ClientRecord:
    submit_time: float
    commit_time: float = float("nan")
    fast_path: bool = False
    retries: int = 0
    result: object = None


class Client:
    """Issues requests through proxies with timeout/retry (S6.5)."""

    def __init__(self, client_id: int, cluster, proxies: list[int],
                 timeout: float = 20e-3, on_commit: Optional[Callable] = None):
        self.id = client_id
        self.cluster = cluster
        self.proxies = proxies
        self.timeout = timeout
        self.on_commit = on_commit
        self.next_request_id = 0
        self.records: dict[int, ClientRecord] = {}
        self._pending: dict[int, dict] = {}
        self._proxy_rr = client_id  # spread clients across proxies

    def submit(self, command=None, op=None, keys=()) -> int:
        from repro_torch.core.messages import OpType

        rid = self.next_request_id
        self.next_request_id += 1
        self.records[rid] = ClientRecord(submit_time=self.cluster.scheduler.now)
        self._pending[rid] = {"command": command, "op": op or OpType.WRITE,
                              "keys": keys, "attempt": 0}
        self._send(rid)
        return rid

    def _send(self, rid: int) -> None:
        if rid not in self._pending:
            return
        p = self._pending[rid]
        proxy = self.proxies[(self._proxy_rr + p["attempt"]) % len(self.proxies)]
        self.cluster.send_client_to_proxy(self.id, proxy, rid, p["command"], p["op"], p["keys"])
        attempt = p["attempt"]
        self.cluster.scheduler.schedule_after(
            self.timeout, lambda: self._maybe_retry(rid, attempt), tag=f"c{self.id}-retry")

    def _maybe_retry(self, rid: int, attempt: int) -> None:
        p = self._pending.get(rid)
        if p is None or p["attempt"] != attempt:
            return
        p["attempt"] += 1
        self.records[rid].retries += 1
        self._send(rid)

    def on_reply(self, request_id: int, result, fast_path: bool) -> None:
        if request_id not in self._pending:
            return  # duplicate commit notification
        del self._pending[request_id]
        rec = self.records[request_id]
        rec.commit_time = self.cluster.scheduler.now
        rec.fast_path = fast_path
        rec.result = result
        if self.on_commit:
            self.on_commit(self, request_id)


__all__ = ["Proxy", "Client", "ClientRecord"]
