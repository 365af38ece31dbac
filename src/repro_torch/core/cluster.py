"""Port of `repro/core/cluster.py`: the unified `Cluster` API, its shared
`CommonConfig` core and the `SummaryDict` schema.

Every backend implements the same small surface -- ``start``, ``submit``,
``submit_at``, ``run_for``, ``crash``/``relaunch``, ``schedule_fault``,
``on_commit``, ``summary`` -- so one workload driver covers them all:
the discrete-event backends over `EventCluster` (`repro_torch.core.protocol`'s
Nezha and `repro_torch.core.baselines`' eight protocols, on the host), the
vectorized data plane (`repro_torch.core.vectorized_cluster`) and the
sharded one (`repro_torch.core.sharded`).

SummaryDict schema: every backend returns at least
``SUMMARY_REQUIRED_KEYS`` -- protocol, backend, n_requests, committed,
fast_commit_ratio, median_latency, p90_latency, mean_latency (seconds; NaN
when nothing committed) -- and may add extra keys.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.clock import ClockParams
from repro_torch.sim.network import NetworkParams
from repro_torch.sim.transport import CpuParams


@dataclass
class CommonConfig:
    """Protocol-agnostic configuration core shared by every backend."""

    f: int = 1                     # tolerated failures; n = 2f + 1 replicas
    n_clients: int = 1
    net: NetworkParams = field(default_factory=NetworkParams)
    clock: ClockParams = field(default_factory=ClockParams)
    client_cpu: CpuParams = field(default_factory=lambda: CpuParams(threads=2.0))
    client_timeout: float = 20e-3
    exec_cost: float = 0.0         # state-machine execution cost (null app: 0)
    seed: int = 0


SUMMARY_REQUIRED_KEYS = frozenset({
    "protocol", "backend", "n_requests", "committed", "fast_commit_ratio",
    "median_latency", "p90_latency", "mean_latency",
})


def summarize_commits(protocol: str, backend: str, latencies: Sequence[float],
                      n_requests: int, n_fast: int, **extra) -> dict:
    """Assemble a schema-conformant SummaryDict from commit latencies."""
    lat = np.asarray([l for l in latencies if np.isfinite(l)], dtype=float)
    committed = int(lat.size)
    out = {
        "protocol": protocol,
        "backend": backend,
        "n_requests": int(n_requests),
        "committed": committed,
        "fast_commit_ratio": n_fast / max(committed, 1),
        "median_latency": float(np.median(lat)) if committed else float("nan"),
        "p90_latency": float(np.percentile(lat, 90)) if committed else float("nan"),
        "mean_latency": float(lat.mean()) if committed else float("nan"),
    }
    out.update(extra)
    return out


class Cluster(abc.ABC):
    """Abstract consensus cluster: the one API every backend implements."""

    protocol: str = "abstract"
    backend: str = "event"
    supports_closed_loop: bool = True   # has per-commit callbacks + event loop
    cfg: CommonConfig

    # -- workload-facing ------------------------------------------------------
    @property
    def n_clients(self) -> int:
        return self.cfg.n_clients

    @property
    @abc.abstractmethod
    def now(self) -> float:
        """Current simulated time in seconds."""

    @abc.abstractmethod
    def submit(self, client_id: int = 0, request_id: Optional[int] = None,
               keys: tuple = (), op=None, command=None) -> tuple[int, int]:
        """Issue one request at the current time; returns its uid."""

    @abc.abstractmethod
    def submit_at(self, t: float, client_id: int = 0, keys: tuple = (),
                  op=None, command=None) -> None:
        """Schedule a submission at absolute simulated time ``t``."""

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        """Bring the cluster up. Default: nothing to do."""

    @abc.abstractmethod
    def run_for(self, duration: float) -> None:
        """Advance simulated time by ``duration`` seconds."""

    def crash(self, rid: int) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not model replica failures")

    def relaunch(self, rid: int) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not model replica failures")

    def schedule_fault(self, event) -> bool:
        """Schedule a typed scenario fault event.

        Events are duck-typed on ``event.kind`` ("crash", "relaunch",
        "clock-fault", "clock-clear", "net-shift", ...) so backends need no
        dependency on a scenario module. Returns True if the event was
        scheduled, False if this backend cannot model it.
        """
        return False

    # -- results ----------------------------------------------------------------
    @abc.abstractmethod
    def summary(self) -> dict:
        """Uniform SummaryDict (see module docstring for the schema)."""

    # ``on_commit`` is a plain settable attribute on concrete classes: a
    # callable ``(client_id, request_id) -> None`` fired once per commit.
    on_commit: Optional[Callable[[int, int], None]] = None


class EventCluster(Cluster):
    """Mixin for discrete-event backends owning a ``self.scheduler``."""

    backend = "event"

    @property
    def now(self) -> float:
        return self.scheduler.now

    def submit_at(self, t: float, client_id: int = 0, keys: tuple = (),
                  op=None, command=None) -> None:
        self.scheduler.schedule_at(
            t, lambda: self.submit(client_id, keys=keys, op=op, command=command),
            tag="inject")

    def run_for(self, duration: float) -> None:
        self.scheduler.run_for(duration)

    def schedule_fault(self, event) -> bool:
        """Event-backend fault application: schedule the event's effect at
        its timestamp on the discrete-event scheduler.

        Capability is checked *up front* (not at fire time): crash/relaunch
        require the concrete class to override `crash`/`relaunch`; clock
        faults require per-node clocks (`clock_of_replica`/`clock_of_proxy`,
        which route to the documented `Clock.inject_fault` hook); net-shift
        only needs the shared fabric and is supported everywhere.
        """
        kind = getattr(event, "kind", None)
        if kind in ("crash", "relaunch"):
            base = Cluster.crash if kind == "crash" else Cluster.relaunch
            if getattr(type(self), kind) is base:       # not overridden
                return False
            if not (0 <= event.rid < self.n):           # fail at schedule time
                raise ValueError(
                    f"replica id {event.rid} out of range [0, {self.n})")
            fn = self.crash if kind == "crash" else self.relaunch
            self.scheduler.schedule_at(event.t, lambda: fn(event.rid),
                                       tag="fault")
            return True
        if kind in ("clock-fault", "clock-clear"):
            if not (hasattr(self, "clock_of_replica")
                    and hasattr(self, "clock_of_proxy")):
                return False
            targets = event.targets(self.n, getattr(self.cfg, "n_proxies", 0))

            def apply() -> None:
                for role, idx in targets:
                    clock = (self.clock_of_replica(idx) if role == "replica"
                             else self.clock_of_proxy(idx))
                    if kind == "clock-fault":
                        clock.inject_fault(event.mu, event.sigma)
                    else:
                        clock.clear_fault()

            self.scheduler.schedule_at(event.t, apply, tag="fault")
            return True
        if kind == "net-shift":
            params = event.params       # resolve now: bad profiles must fail
            self.scheduler.schedule_at(  # at schedule time, not mid-run
                event.t, lambda: self.fabric.network.set_params(params),
                tag="fault")
            return True
        if kind in ("partition", "heal"):
            net = getattr(getattr(self, "fabric", None), "network", None)
            if net is None or not hasattr(net, "set_partition"):
                return False
            if kind == "partition":
                groups, main_idx = event.groups, event.main_group()
                for g in groups:            # fail at schedule time
                    for r in g:
                        if not (0 <= int(r) < self.n):
                            raise ValueError(
                                f"replica id {r} out of range [0, {self.n})")
                self.scheduler.schedule_at(
                    event.t, lambda: self._apply_partition(groups, main_idx),
                    tag="fault")
            else:
                self.scheduler.schedule_at(event.t, self._heal_partition,
                                           tag="fault")
            return True
        if kind in ("gray-link", "gray-clear"):
            net = getattr(getattr(self, "fabric", None), "network", None)
            if net is None or not hasattr(net, "set_gray_pairs"):
                return False
            a = self._link_node_ids(event.src)  # raises on bad selectors now
            b = self._link_node_ids(event.dst)
            if not a or not b:
                return False                    # e.g. "proxies" with none
            if kind == "gray-link":
                mu, sg, dp = event.delay_mu, event.delay_sigma, event.drop_prob
                self.scheduler.schedule_at(
                    event.t, lambda: self._apply_gray(a, b, mu, sg, dp),
                    tag="fault")
            else:
                wipe = event.src == "*" and event.dst == "*"
                self.scheduler.schedule_at(
                    event.t, lambda: self._clear_gray(a, b, wipe), tag="fault")
            return True
        if kind == "skewed-stamper":
            proxies = getattr(self, "proxies", None)
            if not proxies:
                return False
            pid = event.proxy_id % len(proxies)  # wrap like the engine does
            bias = event.bias
            self.scheduler.schedule_at(
                event.t, lambda: setattr(proxies[pid], "stamp_bias", bias),
                tag="fault")
            return True
        if kind == "lossy-acker":
            reps = getattr(self, "replicas", None)
            if not reps or not hasattr(reps[0], "set_lossy"):
                return False
            if not (0 <= event.rid < self.n):   # fail at schedule time
                raise ValueError(
                    f"replica id {event.rid} out of range [0, {self.n})")
            self.scheduler.schedule_at(
                event.t, lambda: reps[event.rid].set_lossy(), tag="fault")
            return True
        if kind in ("sync-outage", "sync-restore", "sync-bias"):
            # Modeled-sync faults: need a probe-driven SyncService;
            # clusters without one (baselines, legacy regimes) skip them.
            sync = getattr(self, "sync", None)
            if sync is None or not getattr(sync, "_modeled", False):
                return False
            if kind == "sync-bias":
                obs = self._sync_clock_ids(event.src)   # fail at schedule
                prs = self._sync_clock_ids(event.dst)   # time on bad selectors
                bias = float(event.bias)
                self.scheduler.schedule_at(
                    event.t, lambda: sync.set_probe_bias(obs, prs, bias),
                    tag="fault")
            else:
                flag = kind == "sync-outage"
                self.scheduler.schedule_at(
                    event.t, lambda: sync.set_outage(flag), tag="fault")
            return True
        if kind == "clock-leap":
            if not (hasattr(self, "clock_of_replica")
                    and hasattr(self, "clock_of_proxy")):
                return False
            targets = event.targets(self.n, getattr(self.cfg, "n_proxies", 0))
            delta = float(event.delta)

            def leap() -> None:
                for role, idx in targets:
                    clock = (self.clock_of_replica(idx) if role == "replica"
                             else self.clock_of_proxy(idx))
                    clock.leap(delta)

            self.scheduler.schedule_at(event.t, leap, tag="fault")
            return True
        return False

    def _sync_clock_ids(self, selector) -> tuple[int, ...]:
        """Resolve a clock-target selector to SyncService clock indices
        (replicas 0..R-1, proxies R..R+P-1, matching the clocks layout)."""
        from repro_torch.sim.scenario import _clock_targets

        n_prox = getattr(self.cfg, "n_proxies", 0)
        if selector == "all":
            return tuple(range(self.n + n_prox))
        out = []
        for role, idx in _clock_targets(selector, self.n, n_prox):
            out.append(idx if role == "replica" else self.n + idx)
        return tuple(out)

    # -- adversarial network faults (Partition/Heal/GrayLink/GrayClear) ------
    # Window bookkeeping is lazily initialized so every EventCluster subclass
    # (none of which call a shared __init__) gets it for free.
    def _net_window_list(self) -> list:
        if not hasattr(self, "_net_windows"):
            self._net_windows: list[dict] = []
            self._partition_open: Optional[dict] = None
            self._gray_t0: Optional[float] = None
        return self._net_windows

    def _replica_progress(self, rid: int) -> int:
        """Durable-log length of replica ``rid`` (0 where unmodeled);
        partition windows snapshot it to measure minority progress."""
        reps = getattr(self, "replicas", None)
        if reps is not None and hasattr(reps[rid], "synced"):
            return len(reps[rid].synced)
        return 0

    def _link_node_ids(self, sel) -> list:
        """Gray-link endpoint selector -> fabric node ids (replicas are
        nodes [0, n); proxies map through `_proxy_node` where one exists)."""
        from repro_torch.sim.scenario import _link_nodes

        rids, pids = _link_nodes(sel, self.n, getattr(self.cfg, "n_proxies", 0))
        nodes = [int(r) for r in rids]
        if pids:
            nodes += [self._proxy_node(p) for p in pids]
        return nodes

    def _apply_partition(self, groups, main_idx: int) -> None:
        self._net_window_list()
        net = self.fabric.network
        # Proxies and clients side with the main group (scenario semantics:
        # minority replicas are cut off from the request path too).
        extra = list(range(self.n, net.n))
        node_groups, minority = [], []
        for gi, g in enumerate(groups):
            ids = [int(r) for r in g]
            if gi == main_idx:
                ids = ids + extra
            else:
                minority.extend(ids)
            node_groups.append(ids)
        net.set_partition(node_groups)
        minority.sort()
        self._partition_open = {
            "t0": self.now, "minority": minority,
            "snap": [self._replica_progress(r) for r in minority]}

    def _heal_partition(self) -> None:
        self._net_window_list()
        po = self._partition_open
        if po is not None:          # close the window BEFORE reconnecting
            self._net_windows.append(self._close_partition_window(po))
            self._partition_open = None
        self.fabric.network.clear_partition()

    def _close_partition_window(self, po: dict) -> dict:
        prog = sum(max(self._replica_progress(r) - s0, 0)
                   for r, s0 in zip(po["minority"], po["snap"]))
        return {"kind": "partition", "t0": po["t0"], "t1": self.now,
                "minority": po["minority"], "minority_progress": int(prog)}

    def _apply_gray(self, a, b, mu: float, sigma: float, drop: float) -> None:
        self._net_window_list()
        net = self.fabric.network
        net.set_gray_pairs(a, b, delay_mu=mu, delay_sigma=sigma, drop_prob=drop)
        if net.gray_active and self._gray_t0 is None:
            self._gray_t0 = self.now

    def _clear_gray(self, a, b, wipe: bool) -> None:
        self._net_window_list()
        net = self.fabric.network
        if wipe:
            net.clear_gray_all()
        else:
            net.clear_gray_pairs(a, b)
        if not net.gray_active and self._gray_t0 is not None:
            self._net_windows.append(
                {"kind": "gray", "t0": self._gray_t0, "t1": self.now})
            self._gray_t0 = None

    def net_windows(self) -> list:
        """Closed fault windows plus any still-open ones (closed at `now`);
        same schema as the vectorized backend's `net_windows()`."""
        out = list(self._net_window_list())
        if self._partition_open is not None:
            out.append(self._close_partition_window(self._partition_open))
        if self._gray_t0 is not None:
            out.append({"kind": "gray", "t0": self._gray_t0, "t1": self.now})
        return out


__all__ = ["CommonConfig", "Cluster", "EventCluster",
           "SUMMARY_REQUIRED_KEYS", "summarize_commits"]
