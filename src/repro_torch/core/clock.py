"""Port of `repro/core/clock.py`: the clock and sync parameters.

The vectorized engine models clocks through `repro_torch.core.clocksync`
(a whole-fleet `ClockSyncDaemon`); the event backend's per-node `Clock` and
`SyncService` are not ported with the vectorized data plane.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ClockParams:
    # Residual error after Huygens sync. Paper: 99th-pct offset 49.6ns in-zone;
    # we default a touch coarser to stay conservative.
    residual_sigma: float = 30e-9
    drift_ppm_sigma: float = 5.0        # crystal drift spread, parts-per-million
    resync_interval: float = 2.0        # offset re-estimation period (s)
    read_jitter: float = 5e-9           # clock-read quantization/jitter
    # -- modeled sync loop (repro_torch.core.clocksync) ----------------------
    sync_model: bool = False            # measure sigma instead of asserting it
    sync_interval: float = 0.02         # probe-round period (s)
    probes_per_peer: int = 8            # burst size per peer (min-RTT filter)
    wander_sigma: float = 1e-7          # random-walk wander (s per sqrt(s))
    step_rate: float = 0.0              # spontaneous VM-migration steps (1/s)
    step_sigma: float = 100e-6          # magnitude spread of such steps
    sigma_floor: float = 200e-9         # reported bound never below this
    sigma_safety: float = 1.5           # MAD -> sigma inflation factor
    slew_rate: float = 500e-6           # correction smear rate (s per s)


__all__ = ["ClockParams"]
