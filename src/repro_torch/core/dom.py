"""Port of `repro/core/dom.py`: the DOM parameters (paper S4).

The deadline bound is clamp(P + beta * (sigma_S + sigma_R), 0, D), with P a
percentile of a sliding window of OWD samples. The vectorized engine
(`repro_torch.core.engine`) evaluates it over a ring pool on the device; the
event-driven early buffer is not ported with the vectorized data plane.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DomParams:
    percentile: float = 50.0        # P's percentile (paper default: 50th)
    window: int = 1000              # sliding-window size for OWD samples
    beta: float = 3.0               # clock-error margin multiplier
    clamp_d: float = 200e-6         # D: clamp ceiling for OWD~ (s)
    initial_owd: float = 100e-6     # bootstrap before samples exist
    zero_bound: bool = False        # ablation (Fig 9 "No-DOM"): l = 0, so
    #   ordering degenerates to leader arrival order via the slow path


__all__ = ["DomParams"]
