"""Port of `repro/core/cluster.py`: the unified `Cluster` API, its shared
`CommonConfig` core and the `SummaryDict` schema.

Every backend implements the same small surface -- ``start``, ``submit``,
``submit_at``, ``run_for``, ``crash``/``relaunch``, ``schedule_fault``,
``on_commit``, ``summary`` -- so one workload driver covers them all. The
port has one backend, `repro_torch.core.vectorized_cluster`; the
discrete-event mixin (`EventCluster`) is not ported with it.

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


__all__ = ["CommonConfig", "Cluster", "SUMMARY_REQUIRED_KEYS",
           "summarize_commits"]
