"""Port of `repro/sim/transport.py`: the per-node CPU cost parameters.

`CommonConfig` carries the client CPU model; the event-driven fabric that
consumes it (`SimFabric`) is not ported with the vectorized data plane.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CpuParams:
    send_cost: float = 0.45e-6
    recv_cost: float = 1.05e-6
    threads: float = 1.0      # effective parallel service (multithreaded nodes)


__all__ = ["CpuParams"]
