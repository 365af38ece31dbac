"""Port of `repro/sim/transport.py` (copied).

SimFabric: network + per-node CPU model shared by Nezha and the baselines.

Throughput saturation in the paper's Fig 8 comes from nodes running out of
CPU (the leader bottleneck), not from network bandwidth. We model each node
as a non-preemptive FIFO server: every message *send* costs `send_cost` and
every *receive* costs `recv_cost` on the node's single logical core (threads
scale capacity by 1/threads). Network OWDs/drops come from CloudNetwork.

Defaults are calibrated so a 16-vCPU replica processes ~0.7M msgs/s --
consistent with the C++/UDP implementations the paper benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.sim.events import EventScheduler
from repro_torch.sim.network import CloudNetwork, NetworkParams


@dataclass
class CpuParams:
    send_cost: float = 0.45e-6
    recv_cost: float = 1.05e-6
    threads: float = 1.0      # effective parallel service (multithreaded nodes)


class SimFabric:
    """Transport with per-node CPU accounting."""

    def __init__(self, n_nodes: int, net: Optional[NetworkParams] = None, seed: int = 0):
        self.scheduler = EventScheduler()
        self.network = CloudNetwork(n_nodes, net, seed=seed)
        self.n_nodes = n_nodes
        self._busy = np.zeros(n_nodes)       # busy-until timestamp
        self._work = np.zeros(n_nodes)       # accumulated service seconds
        self._cpu = [CpuParams() for _ in range(n_nodes)]
        self.msg_count = 0

    def set_cpu(self, node: int, params: CpuParams) -> None:
        self._cpu[node] = params

    def cpu_utilization(self, node: int) -> float:
        now = self.scheduler.now
        return min(1.0, self._work[node] / now) if now > 0 else 0.0

    def _occupy(self, node: int, cost: float) -> float:
        """Serialize `cost` seconds of work on `node`; returns completion time."""
        service = cost / max(self._cpu[node].threads, 1e-9)
        start = max(self.scheduler.now, self._busy[node])
        done = start + service
        self._busy[node] = done
        self._work[node] += service
        return done

    def send(self, src: int, dst: int, fn: Callable[[], None],
             send_cost: Optional[float] = None, recv_cost: Optional[float] = None) -> None:
        """Charge src's CPU, traverse the network, charge dst's CPU, run fn."""
        sc = self._cpu[src].send_cost if send_cost is None else send_cost
        rc = self._cpu[dst].recv_cost if recv_cost is None else recv_cost
        depart = self._occupy(src, sc)
        owd = self.network.sample_owd(src, dst)
        if owd is None:
            return  # dropped in the fabric
        self.msg_count += 1
        arrival = depart + owd

        def on_arrival() -> None:
            done = self._occupy(dst, rc)
            self.scheduler.schedule_at(done, fn, tag="cpu")

        self.scheduler.schedule_at(arrival, on_arrival, tag="net")

    def local(self, node: int, fn: Callable[[], None], cost: float) -> None:
        """Run fn on node's CPU without a network hop (co-located work)."""
        done = self._occupy(node, cost)
        self.scheduler.schedule_at(done, fn, tag="cpu")


__all__ = ["SimFabric", "CpuParams"]
