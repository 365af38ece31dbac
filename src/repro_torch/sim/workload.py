"""Port of `repro/sim/workload.py`: open- and closed-loop workloads (S9.1:
`OpenLoopWorkload`, `ClosedLoopWorkload`, `RequestRecord`,
`summarize_latencies`) and the `WorkloadDriver` that injects either
shape into a cluster through the unified submit/submit_at/run_for/summary
surface.

Open loop: requests arrive per a Poisson process regardless of replies.
Closed loop: a client resubmits when its previous request commits; the
vectorized engine fires ``on_commit`` while flushing each epoch with
``cluster.now`` set to the commit's client-side time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.core.hashing import key_group_np
from repro_torch.core.messages import OpType


@dataclass
class RequestRecord:
    client_id: int
    request_id: int
    submit_time: float
    commit_time: float = float("nan")
    fast_path: bool = False
    retries: int = 0

    @property
    def latency(self) -> float:
        return self.commit_time - self.submit_time


class OpenLoopWorkload:
    """Poisson arrivals at `rate` req/s per client; multiple outstanding."""

    def __init__(self, n_clients: int, rate_per_client: float, seed: int = 0):
        self.n_clients = n_clients
        self.rate = rate_per_client
        self.rng = np.random.default_rng(seed)

    def arrival_times(self, duration: float) -> list[tuple[float, int]]:
        """(time, client_id) tuples, time-sorted."""
        out: list[tuple[float, int]] = []
        for c in range(self.n_clients):
            t = 0.0
            while True:
                t += self.rng.exponential(1.0 / self.rate)
                if t > duration:
                    break
                out.append((t, c))
        out.sort()
        return out

    def arrival_array(self, duration: float) -> tuple[np.ndarray, np.ndarray]:
        arr = self.arrival_times(duration)
        if not arr:
            return np.zeros(0), np.zeros(0, dtype=np.int64)
        t, c = zip(*arr)
        return np.asarray(t), np.asarray(c, dtype=np.int64)


class ClosedLoopWorkload:
    """Back-to-back requests; think time ~0. Driven by the event simulator:
    the protocol under test calls `on_commit(client_id)` and we immediately
    issue the next request via the `submit` callback."""

    def __init__(self, n_clients: int, submit: Callable[[int], None],
                 think_time: float = 0.0, seed: int = 0):
        self.n_clients = n_clients
        self.submit = submit
        self.think_time = think_time
        self.rng = np.random.default_rng(seed)

    def start(self) -> None:
        for c in range(self.n_clients):
            self.submit(c)

    def on_commit(self, client_id: int, schedule_after: Callable[[float, Callable[[], None]], None]) -> None:
        if self.think_time > 0:
            schedule_after(self.rng.exponential(self.think_time), lambda: self.submit(client_id))
        else:
            self.submit(client_id)


def zipf_key(rng: np.random.Generator, n_keys: int, theta: float) -> int:
    """YCSB-style zipfian(theta) over [0, n_keys): P(i) ~ (i+1)^-theta.

    Inverse-CDF approximation of the truncated zipfian: continuous CDF
    F(x) = x^(1-theta) / N^(1-theta)  =>  x = N * u^(1/(1-theta)).
    theta=0 is uniform; theta=0.99 is the YCSB 'hotspot' default.
    """
    if theta <= 0.0:
        return int(rng.integers(0, n_keys))
    u = rng.random()
    x = n_keys * (u ** (1.0 / (1.0 - min(theta, 0.999))))
    return min(int(x), n_keys - 1)


def route_keys(keys, n_groups: int) -> np.ndarray:
    """Deterministic key -> consensus-group routing (sharded Nezha).

    The single routing seam the workload layer and `nezha-sharded` backend
    share: stable splitmix64 hashing (`repro_torch.core.hashing.key_group_np`),
    NOT the builtin ``hash()``, so group assignment is identical across
    PYTHONHASHSEED values and process restarts."""
    return key_group_np(np.asarray(keys, dtype=np.uint64), n_groups)


def summarize_latencies(records: list[RequestRecord]) -> dict:
    lat = np.asarray([r.latency for r in records if np.isfinite(r.commit_time)])
    committed = int(np.isfinite([r.commit_time for r in records]).sum())
    fast = sum(1 for r in records if r.fast_path and np.isfinite(r.commit_time))
    out = {
        "n": len(records),
        "committed": committed,
        "fast_commit_ratio": fast / max(committed, 1),
    }
    if lat.size:
        out.update(
            median_latency=float(np.median(lat)),
            p90_latency=float(np.percentile(lat, 90)),
            mean_latency=float(lat.mean()),
        )
    return out


# ---------------------------------------------------------------------------
# Unified workload driver (any registered cluster)
# ---------------------------------------------------------------------------
@dataclass
class Workload:
    """One benchmark workload: injection shape + key/op distribution.

    mode="open":   Poisson arrivals at `rate_per_client` req/s per client,
                   injected from `warmup` to `duration`; throughput is
                   committed / (duration - warmup).
    mode="closed": `lanes` outstanding requests per client, resubmitted on
                   commit until `duration`; throughput is committed/duration.
    """

    mode: str = "open"                  # "open" | "closed"
    rate_per_client: float = 2000.0     # open-loop Poisson rate per client
    duration: float = 0.2               # injection horizon (simulated s)
    warmup: float = 0.02                # open loop: skip-start (estimators warm)
    drain: float = 0.1                  # extra run time for in-flight commits
    read_ratio: float = 0.5
    skew: float = 0.5                   # zipf theta (0 = uniform)
    n_keys: int = 1_000_000
    lanes: int = 1                      # closed loop: outstanding per client
    seed: int = 0
    multiop_ratio: float = 0.0          # fraction of ops touching several keys
    #   (sharded MultiOp: keys spanning groups commit atomically in global
    #   deadline order). 0.0 draws NOTHING extra from the rng -- the default
    #   stream is bit-identical to pre-multiop workloads.
    multiop_span: int = 2               # keys per multi-key op (>= 2)


class WorkloadDriver:
    """Drives a `Workload` against any unified-API cluster.

    Returns the cluster's `summary()` extended with ``throughput`` and
    (open loop) ``offered`` or (closed loop) ``n_clients``.
    """

    def __init__(self, workload: Optional[Workload] = None, **kw):
        self.workload = workload if workload is not None else Workload(**kw)
        if workload is not None and kw:
            raise TypeError("pass either a Workload or keyword overrides, not both")

    def _next_op(self, rng) -> tuple:
        w = self.workload
        key = zipf_key(rng, w.n_keys, w.skew)
        op = OpType.READ if rng.random() < w.read_ratio else OpType.WRITE
        return key, op

    def _next_keys(self, rng, key: int) -> tuple:
        """The key set of one request: usually ``(key,)``; with probability
        ``multiop_ratio`` a multi-key op of ``multiop_span`` distinct keys.
        The guard short-circuits at ratio 0.0 so default workloads draw
        nothing extra from the rng (bit-identical streams)."""
        w = self.workload
        if w.multiop_ratio <= 0.0 or rng.random() >= w.multiop_ratio:
            return (key,)
        keys = [key]
        while len(keys) < max(int(w.multiop_span), 2):
            k = zipf_key(rng, w.n_keys, w.skew)
            if k not in keys:
                keys.append(k)
        return tuple(keys)

    def inject_open_loop(self, cluster) -> None:
        """Pre-schedule the open-loop arrivals (Poisson per client, zipf keys,
        read/write mix) without running the cluster. `run` is built on this;
        callers that need custom stepping (e.g. a crash mid-run) inject here
        and drive `run_for` themselves."""
        w = self.workload
        rng = np.random.default_rng(w.seed)
        for cid in range(cluster.n_clients):
            t = w.warmup
            while t < w.duration:
                t += rng.exponential(1.0 / w.rate_per_client)
                key, op = self._next_op(rng)
                cluster.submit_at(t, cid, keys=self._next_keys(rng, key),
                                  op=op)

    def run(self, cluster) -> dict:
        w = self.workload
        cluster.start()
        if w.mode == "open":
            self.inject_open_loop(cluster)
            cluster.run_for(w.duration + w.drain)
            s = cluster.summary()
            s["throughput"] = s["committed"] / max(w.duration - w.warmup, 1e-9)
            s["offered"] = w.rate_per_client * cluster.n_clients
        elif w.mode == "closed":
            if not cluster.supports_closed_loop:
                raise ValueError(
                    f"{type(cluster).__name__} cannot run closed-loop "
                    "workloads; use mode='open'")
            rng = np.random.default_rng(w.seed)

            def on_commit(cid, rid):
                if cluster.now < w.duration:
                    key, op = self._next_op(rng)
                    cluster.submit(cid, keys=(key,), op=op)

            cluster.on_commit = on_commit
            for cid in range(cluster.n_clients):
                for _ in range(w.lanes):
                    key, op = self._next_op(rng)
                    cluster.submit(cid, keys=(key,), op=op)
            cluster.run_for(w.duration + w.drain)
            s = cluster.summary()
            s["throughput"] = s["committed"] / w.duration
            s["n_clients"] = cluster.n_clients
        else:
            raise ValueError(f"unknown workload mode {w.mode!r}")
        return s


__all__ = ["RequestRecord", "OpenLoopWorkload", "ClosedLoopWorkload",
           "summarize_latencies", "Workload", "WorkloadDriver", "zipf_key",
           "route_keys"]
