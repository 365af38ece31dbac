"""Port of `repro/core/clock.py` (copied).

Clock models and Huygens-style synchronization (paper S2.1, Appendix D).

Each node owns a :class:`Clock` mapping reference time -> local time:

    c_i(t) = t + offset_i + drift_i * (t - t0) + slew(t) + wander + jitter

A :class:`SyncService` periodically estimates and corrects offsets. Two
modes:

  legacy (``sync_model=False``, the default): the Huygens stand-in --
  each resync draws a fresh N(0, residual_sigma) residual. Corrections
  are SMEARED in at a bounded slew rate rather than stepped (a step used
  to pull local time backwards by up to drift * resync_interval), and
  per-clock resync phases are staggered with seeded jitter (a fleet-wide
  same-instant resync erased all relative-offset structure at once).

  measured (``sync_model=True``): the service runs the NTP-style probe
  loop from `repro_torch.core.clocksync` -- two-way probes against every peer
  through the shared `CloudNetwork`, min-RTT filtering, outlier
  rejection, masked-median estimation -- and `sigma_estimate` becomes the
  estimator's HONEST error bound: measured each round, growing at the
  3-sigma drift rate between rounds (so a daemon outage widens DOM's
  beta * (sigma_S + sigma_R) margin instead of silently keeping it
  optimistic).

Correctness never depends on these clocks (S2.1, Liskov's rule): protocol
code treats clock reads as arbitrary values; tests inject adversarial skews
(Appendix D's N(mu, sigma) offset injection is reproduced verbatim).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.clocksync import (PROBE_SEED, STAGGER_SEED, STEP_FLOOR_MULT,
                                  STEP_SIGMA_MULT, estimate_offsets)


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


class Clock:
    """A node's local clock. `read(t_ref)` returns local time at reference t."""

    def __init__(self, node_id: int, params: Optional[ClockParams] = None,
                 seed: int = 0, synchronized: bool = True):
        self.node_id = node_id
        self.params = params or ClockParams()
        self.rng = np.random.default_rng(seed * 1_000_003 + node_id)
        p = self.params
        self.offset = float(self.rng.normal(0.0, p.residual_sigma)) if synchronized else \
            float(self.rng.uniform(-0.5, 0.5))
        self.drift = float(self.rng.normal(0.0, p.drift_ppm_sigma * 1e-6))
        self._last_sync = 0.0
        self._monotonic_floor = -np.inf
        # Injected fault (Appendix D): extra offset distribution N(mu, sigma).
        self._fault_mu = 0.0
        self._fault_sigma = 0.0
        # In-progress smeared correction: `_slew_delta` is applied
        # progressively at `slew_rate` from `_slew_from` on (satellite fix:
        # a stepped resync could move local time backwards).
        self._slew_from = 0.0
        self._slew_delta = 0.0
        # Random-walk wander, on its OWN stream so arming the clock process
        # cannot perturb the read()/resync() draw sequence.
        self._wander = 0.0
        self._wander_t = 0.0
        self._wander_rng = (
            np.random.default_rng(seed * 1_000_003 + node_id + 0x77AA)
            if p.sync_model and p.wander_sigma > 0.0 else None)
        # Reported bound: a measurement timestamp + base value. With
        # sync_model off this stays the frozen configured constant
        # (bit-compatible with the unmodeled attribute).
        self._sigma_base = p.residual_sigma
        self._sigma_t = 0.0
        self._last_read_t = 0.0

    # -- fault injection (Appendix D) ---------------------------------------
    def inject_fault(self, mu: float, sigma: float) -> None:
        """Add N(mu, sigma) to every read - mimics bad synchronization."""
        self._fault_mu = mu
        self._fault_sigma = sigma

    def clear_fault(self) -> None:
        self._fault_mu = 0.0
        self._fault_sigma = 0.0

    # -- reported error bound ------------------------------------------------
    @property
    def sigma_estimate(self) -> float:
        """What the sync service reports (sigma_S/sigma_R in S4). Under the
        modeled sync loop this is the estimator's measured bound grown at
        the 3-sigma drift rate since its measurement; legacy mode keeps the
        frozen configured constant."""
        return self.sigma_at(self._last_read_t)

    @sigma_estimate.setter
    def sigma_estimate(self, value: float) -> None:
        self._sigma_base = float(value)
        self._sigma_t = self._last_sync

    def sigma_at(self, t_ref: float) -> float:
        p = self.params
        if not p.sync_model:
            return self._sigma_base
        growth = 3.0 * p.drift_ppm_sigma * 1e-6 + p.wander_sigma
        sig = self._sigma_base + growth * max(0.0, t_ref - self._sigma_t)
        # An in-progress smeared correction is KNOWN remaining error: a
        # 300us step takes |delta|/slew_rate seconds to slew out, and the
        # reported bound must cover the part not yet applied (subsequent
        # rounds re-measure a shrinking offset and would otherwise smooth
        # the bound down faster than the slew removes the error).
        rem = abs(self._slew_delta) - abs(self._slew_applied(t_ref))
        return max(sig, rem)

    # -- reads ---------------------------------------------------------------
    def _slew_applied(self, t_ref: float) -> float:
        d = self._slew_delta
        if d == 0.0:
            return 0.0
        lim = self.params.slew_rate * max(0.0, t_ref - self._slew_from)
        return float(np.sign(d) * min(abs(d), lim))

    def _wander_at(self, t_ref: float) -> float:
        if self._wander_rng is None:
            return 0.0
        dt = t_ref - self._wander_t
        if dt > 0.0:
            self._wander += float(self._wander_rng.normal(
                0.0, self.params.wander_sigma * np.sqrt(dt)))
            self._wander_t = t_ref
        return self._wander

    def _effective_offset(self, t_ref: float) -> float:
        return (self.offset + self.drift * (t_ref - self._last_sync)
                + self._slew_applied(t_ref) + self._wander_at(t_ref))

    def probe_offset(self, t_ref: float) -> float:
        """The deterministic effective offset a sync probe exchanges: no
        read jitter, no injected-fault draw (and no main-stream rng use)."""
        return float(self._effective_offset(t_ref))

    def read(self, t_ref: float) -> float:
        """Local clock time at reference time t_ref (non-monotonic in general)."""
        p = self.params
        t = t_ref + self._effective_offset(t_ref)
        t += self.rng.normal(0.0, p.read_jitter)
        if self._fault_sigma > 0.0 or self._fault_mu != 0.0:
            t += self.rng.normal(self._fault_mu, self._fault_sigma)
        self._last_read_t = max(self._last_read_t, t_ref)
        return float(t)

    def read_monotonic(self, t_ref: float) -> float:
        """DOM's monotonized read (Appendix G.3.3): retry/dispose semantics ==
        clamping below the last returned value."""
        t = self.read(t_ref)
        if t <= self._monotonic_floor:
            t = np.nextafter(self._monotonic_floor, np.inf)
        self._monotonic_floor = t
        return float(t)

    # -- corrections ---------------------------------------------------------
    def _fold_state(self, t_ref: float) -> float:
        """Fold accrued drift, applied slew, and wander into the base offset
        so a new correction starts from the clock's CURRENT effective value
        (the old resync discarded all of it, stepping time backwards)."""
        eff = self._effective_offset(t_ref)
        self.offset = eff
        self._wander = 0.0           # absorbed into offset; walk continues
        self._slew_delta = 0.0
        self._slew_from = t_ref
        self._last_sync = t_ref
        return eff

    def resync(self, t_ref: float) -> None:
        """Huygens correction (legacy mode): re-estimate the offset as a
        fresh N(0, residual_sigma) residual, smeared in at the bounded slew
        rate. The residual draw is unchanged from the stepped version, so
        the rng stream stays bit-compatible; only the application is
        monotone now (derivative 1 + drift - slew_rate stays positive for
        any plausible drift)."""
        p = self.params
        eff = self._fold_state(t_ref)
        target = float(self.rng.normal(0.0, p.residual_sigma))
        self._slew_delta = target - eff
        self.sigma_estimate = p.residual_sigma

    def correct(self, t_ref: float, est: float, sigma: float) -> None:
        """Measured correction (sync_model): smear the estimator's ``est``
        toward the fleet median in at the slew rate, and adopt its measured
        error bound ``sigma`` (timestamped: it grows until re-measured)."""
        self._fold_state(t_ref)
        self._slew_delta = float(est)
        self._sigma_base = max(float(sigma), self.params.sigma_floor)
        self._sigma_t = t_ref

    def leap(self, delta: float) -> None:
        """A true clock step (VM migration / scenario ClockLeap)."""
        self.offset += float(delta)


class SyncService:
    """Drives periodic clock corrections on an EventScheduler.

    Per-clock ticks are STAGGERED with seeded jitter (clock i's phase is
    u_i * interval): a same-instant fleet-wide resync erased all relative-
    offset structure in one step, which is neither how Huygens behaves nor
    survivable by anything that consumes pairwise offsets.

    With ``params.sync_model`` and a ``network``, each tick runs one
    NTP-style probe round for its clock through `repro_torch.core.clocksync`'s
    estimator (shared with the vectorized daemon) and applies a measured
    `Clock.correct`; otherwise it falls back to the legacy `Clock.resync`.
    Evidence rows (t, node, true fleet-relative error, reported sigma) are
    recorded pre-correction at every tick -- including outage ticks, where
    only the probes stop -- for `repro_torch.sim.trace`'s coverage check.
    """

    def __init__(self, clocks: list[Clock], scheduler,
                 params: Optional[ClockParams] = None, *,
                 network=None, seed: int = 0):
        self.clocks = clocks
        self.scheduler = scheduler
        self.params = params or ClockParams()
        self.network = network
        self._stopped = False
        self._outage = False
        self._probe_rng = np.random.default_rng(seed + PROBE_SEED)
        self._jitter_rng = np.random.default_rng(seed + STAGGER_SEED)
        self.probe_bias: Optional[np.ndarray] = None   # [K, K] or None
        self.evidence: list[tuple] = []   # (t, node, err, sigma) rows
        self.events: list[dict] = []      # step/outage/restore records
        self._rounds = [0] * len(clocks)  # per-clock measured-round count

    @property
    def _modeled(self) -> bool:
        return bool(self.params.sync_model) and self.network is not None \
            and len(self.clocks) >= 2

    def start(self) -> None:
        p = self.params
        interval = p.sync_interval if self._modeled else p.resync_interval
        for i in range(len(self.clocks)):
            phase = float(self._jitter_rng.random()) * interval
            self.scheduler.schedule_after(
                phase, lambda i=i: self._tick_one(i), tag="clock-sync")

    def stop(self) -> None:
        """Halt the service entirely (teardown semantics). Scenario-driven
        daemon outages use `set_outage` instead: ticks keep reporting the
        (growing) bound, only the probe/correction work stops."""
        self._stopped = True

    def set_outage(self, flag: bool) -> None:
        if flag != self._outage:
            self.events.append({"kind": "outage" if flag else "restore",
                                "t": float(self.scheduler.now)})
        self._outage = bool(flag)

    def set_probe_bias(self, observers, peers, bias: float) -> None:
        k = len(self.clocks)
        if self.probe_bias is None:
            self.probe_bias = np.zeros((k, k))
        obs = np.asarray(list(observers), np.int64)
        prs = np.asarray(list(peers), np.int64)
        self.probe_bias[np.ix_(obs, prs)] = bias
        if not self.probe_bias.any():
            self.probe_bias = None

    # -- ticks ---------------------------------------------------------------
    def _tick(self) -> None:
        """Legacy entry point (kept for callers that drove ticks manually):
        one immediate resync of every clock, no reschedule."""
        if self._stopped:
            return
        for c in self.clocks:
            c.resync(self.scheduler.now)

    def _tick_one(self, i: int) -> None:
        if self._stopped:
            return
        p = self.params
        now = self.scheduler.now
        if self._modeled:
            self._record(i, now)
            if not self._outage:
                self._probe_round(i, now)
            interval = p.sync_interval
        else:
            self.clocks[i].resync(now)
            interval = p.resync_interval
        self.scheduler.schedule_after(
            interval, lambda: self._tick_one(i), tag="clock-sync")

    def _record(self, i: int, now: float) -> None:
        eff = [c.probe_offset(now) for c in self.clocks]
        ref = float(np.median(eff))
        self.evidence.append((float(now), int(i), float(eff[i] - ref),
                              float(self.clocks[i].sigma_at(now))))

    def _probe_round(self, i: int, now: float) -> None:
        """One two-way probe burst from clock i against every peer, fed to
        the shared estimator as a single-row reduction."""
        p = self.params
        k = len(self.clocks)
        c = self.clocks[i]
        theta = np.zeros((1, k))
        rtt = np.full((1, k), np.inf)
        own = c.probe_offset(now)
        b = int(p.probes_per_peer)
        for j in range(k):
            if j == i:
                continue
            d_f = self.network.sample_probe_owd([i], [j], b, self._probe_rng)[0]
            d_b = self.network.sample_probe_owd([j], [i], b, self._probe_rng)[0]
            pick = int(np.argmin(d_f + d_b))
            if not np.isfinite(d_f[pick] + d_b[pick]):
                continue
            rtt[0, j] = d_f[pick] + d_b[pick]
            theta[0, j] = (self.clocks[j].probe_offset(now) - own) \
                + (d_f[pick] - d_b[pick]) / 2.0
            if self.probe_bias is not None:
                theta[0, j] += self.probe_bias[i, j]
        est, sigma = estimate_offsets(theta, rtt, np,
                                      np.float64(p.sigma_safety),
                                      np.float64(p.sigma_floor))
        if not np.isfinite(rtt).any():
            return      # heard nobody: keep growing from the last measurement
        est0, sig0 = float(est[0]), float(sigma[0])
        prev = c.sigma_at(now)
        # The first measured round CALIBRATES the bound: before it, sigma
        # still reflects the configured bootstrap residual (tens of ns),
        # far below the probe estimator's own noise floor, so any honest
        # first correction would misclassify as a step.
        first = self._rounds[i] == 0
        self._rounds[i] += 1
        if not first and abs(est0) > max(STEP_SIGMA_MULT * prev,
                                         STEP_FLOOR_MULT * p.sigma_floor):
            self.events.append({"kind": "step", "t": float(now),
                                "node": int(i), "magnitude": est0})
            sig0 = max(sig0, abs(est0))
        else:
            # Two-round smoothing, mirroring the vectorized daemon.
            sig0 = max(0.5 * (c._sigma_base + sig0), p.sigma_floor)
        c.correct(now, est0, sig0)

    def evidence_columns(self) -> dict:
        if not self.evidence:
            return {}
        ev = self.evidence
        return {"t": np.asarray([e[0] for e in ev]),
                "node": np.asarray([e[1] for e in ev], np.int64),
                "err": np.asarray([e[2] for e in ev]),
                "sigma": np.asarray([e[3] for e in ev]),
                "events": list(self.events)}


__all__ = ["ClockParams", "Clock", "SyncService"]
