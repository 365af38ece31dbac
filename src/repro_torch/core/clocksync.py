"""Port of `repro/core/clocksync.py` (copied; `estimate_offsets` also runs
on torch tensors, inside the fused epoch body).

Modeled clock-sync loop: clock processes + an NTP-style estimator.

Replaces an *asserted* sync quality (a configured ``residual_sigma`` that
DOM consumed on faith) with a *measured* one:

  truth    each node's clock is a process -- a per-node drift rate, a
           random-walk wander term, and optional step events (VM migration /
           leap), advanced deterministically per epoch;
  probes   a periodic sync round exchanges ``probes_per_peer`` two-way
           probes with every peer THROUGH `CloudNetwork`, so persistent
           path asymmetry, jitter, bursts, drops, and any installed
           partition/gray faults bias the measurements exactly as they
           would bias NTP;
  filter   per (node, peer): min-RTT probe selection (the classic NTP
           clock filter); per node: peers whose best RTT exceeds 3x the
           row's median RTT are rejected as outliers;
  estimate the per-node offset estimate is the masked median of the
           surviving peer offsets theta[i, p] = (eff_p - eff_i)
           + (d_fwd - d_back)/2, and the *honest error bound* is
           1.4826 * MAD * sigma_safety + sigma_floor -- a measurement,
           not a parameter. Between rounds the reported bound GROWS at
           the 3-sigma drift rate: a daemon outage widens the bound
           instead of silently keeping DOM optimistic.

`estimate_offsets` is written as pure per-node reductions (sort-based
masked medians) with one op order for numpy and torch, so the vectorized
engine runs it INSIDE the fused epoch body (theta/rtt ride the epoch as
boundary operands, like ``stamp_off``/``arr_off``) and the host reproduces
it bit for bit when a round lands on an epoch with no dispatch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# rng stream tags (cfg.seed + tag): the daemon owns its streams, never the
# engine's fault stream (seed + 0xC10C) or the network's data-plane stream.
TRUTH_SEED = 0x51CC          # clock-process truth (drift/wander/steps)
PROBE_SEED = 0x5EED          # probe-path sampling through CloudNetwork
STAGGER_SEED = 0x5A66        # event-backend per-clock phase jitter

# Step detection: a measured correction this far outside the previously
# reported bound is a clock step (VM migration), not drift. 6x the grown
# sigma is far above clean-round corrections (drift accrues ~1 sigma of
# the growth rate between rounds) while a 300us leap clears it instantly.
STEP_SIGMA_MULT = 6.0
STEP_FLOOR_MULT = 8.0


def _is_torch(xp) -> bool:
    return getattr(xp, "__name__", "") == "torch"


def _masked_median(x, valid, xp):
    """Per-row median over the entries where ``valid`` is True.

    Sort-based with +inf fill so the op order is identical under numpy and
    torch (bitwise parity across the two): for m valid entries the median
    is (sorted[(m-1)//2] + sorted[m//2]) / 2. Rows with zero valid entries
    return +inf; callers mask them out.
    """
    big = xp.where(valid, x, xp.inf)
    if _is_torch(xp):
        srt = xp.sort(big, dim=1).values
        m = valid.sum(dim=1)
        lo = xp.clamp_min((m - 1) // 2, 0)
        hi = xp.clamp_min(m // 2, 0)
        lo_v = xp.take_along_dim(srt, lo[:, None], dim=1)[:, 0]
        hi_v = xp.take_along_dim(srt, hi[:, None], dim=1)[:, 0]
    else:
        srt = xp.sort(big, axis=1)
        m = valid.sum(axis=1)
        lo = xp.maximum((m - 1) // 2, 0)
        hi = xp.maximum(m // 2, 0)
        lo_v = xp.take_along_axis(srt, lo[:, None], axis=1)[:, 0]
        hi_v = xp.take_along_axis(srt, hi[:, None], axis=1)[:, 0]
    return xp.where(m > 0, (lo_v + hi_v) / 2.0, xp.inf)


def estimate_offsets(theta, rtt, xp, safety, floor):
    """One sync round's per-node reductions: offset estimate + honest bound.

    theta[i, p]  node i's NTP offset sample of peer p (self entries carry
                 rtt = +inf and are never valid);
    rtt[i, p]    the selected probe's round-trip time (+inf = lost).

    Outlier rejection: a peer is valid iff its RTT is finite and at most
    3x the row's median finite RTT (congested/biased paths measure badly
    and are cut). est[i] is the masked median of the surviving theta row
    (0.0 when NO peer survives -- the caller's between-round growth covers
    that case); sigma[i] = 1.4826 * MAD * safety + floor, the normal-
    consistent robust spread of the surviving samples.

    Pure per-node reductions in one fixed op order: `xp` is numpy on the
    host and torch inside the fused epoch body (float64 tensors on the
    engine's device), and the two agree bit for bit.
    """
    fin = xp.isfinite(rtt)
    med_rtt = _masked_median(rtt, fin, xp)
    valid = fin & (rtt <= 3.0 * med_rtt[:, None])
    est = _masked_median(theta, valid, xp)
    est = xp.where(xp.isfinite(est), est, 0.0)
    mad = _masked_median(xp.abs(theta - est[:, None]), valid, xp)
    mad = xp.where(xp.isfinite(mad), mad, 0.0)
    # Fold the constant into the scalar FIRST (one non-constant multiply, as
    # the reference keeps it against XLA's reassociation), and keep the
    # maximum() fence (a no-op, MAD >= 0) between the multiply and the add
    # so no compiler can contract them into an FMA.
    scaled = mad * (1.4826 * safety)
    fenced = (xp.clamp_min(scaled, 0.0) if _is_torch(xp)
              else xp.maximum(scaled, 0.0))
    sigma = fenced + floor
    return est, sigma


class ClockSyncDaemon:
    """The vectorized fleet's clock truth + sync-daemon state.

    Owns the TRUE per-node clock process (offset, drift, wander, steps) for
    the ``n_replicas + n_proxies`` synchronized nodes, and the estimator
    state the protocol is allowed to see: per-node corrections and measured
    error bounds. The engine folds the *effective* residual offsets
    (truth minus correction) into ``clock_stamp_off``/``clock_arr_off``
    each epoch and feeds the measured bounds into DOM's beta-margin, so
    sync quality -- and every failure of it -- reaches the protocol only
    through measurements.

    Probe rounds fire every ``sync_interval`` seconds. A due round samples
    its theta/rtt arrays at the round time; the NEXT fused epoch carries
    them as boundary operands and returns est/sigma from inside the body
    (`consume_round`), while an epoch with no dispatch applies the
    bit-identical numpy twin (`apply_pending`).

    Evidence rows (t, per-node true fleet-relative error, per-node reported
    sigma) are recorded at every interval tick, INCLUDING outage ticks
    (where the reported bound is the grown one) -- a trace checker's
    coverage check reads them.
    """

    def __init__(self, n_replicas: int, n_proxies: int, params,
                 net, seed: int = 0):
        self.n = int(n_replicas)
        self.n_proxies = int(n_proxies)
        self.m = self.n + self.n_proxies
        self.params = params
        self.net = net
        self.rng = np.random.default_rng(seed + TRUTH_SEED)
        self.probe_rng = np.random.default_rng(seed + PROBE_SEED)
        p = params
        # Truth: start Huygens-synchronized (the same N(0, residual_sigma)
        # residual the event Clock draws) with per-node crystal drift.
        self.offset = self.rng.normal(0.0, p.residual_sigma, self.m)
        self.drift = self.rng.normal(0.0, p.drift_ppm_sigma * 1e-6, self.m)
        self.correction = np.zeros(self.m)
        # Measured bound state: before the first round, the configured
        # residual is all anyone can report (it is immediately replaced).
        self.sigma = np.full(self.m, max(p.sigma_floor, p.residual_sigma))
        self._sigma_t = np.zeros(self.m)
        # Reported bounds grow between measurements at the 3-sigma drift
        # rate (plus the wander rate): time since the last round bounds the
        # unobserved drift excursion.
        self.growth = 3.0 * p.drift_ppm_sigma * 1e-6 + p.wander_sigma
        self._t = 0.0
        self._next_round = float(p.sync_interval)
        self.outage = False
        self.probe_bias: Optional[np.ndarray] = None     # [M, M] or None
        self.pending: Optional[tuple] = None  # (t_round, theta[M,M], rtt[M,M])
        self.rounds = 0
        self.evidence: list[tuple] = []       # (t, err[M], sigma[M]) rows
        self.events: list[dict] = []          # step/outage/restore records

    # -- protocol-visible state ---------------------------------------------
    def eff(self) -> np.ndarray:
        """Effective residual offsets: what stamps/arrivals actually see."""
        return self.offset - self.correction

    def stamp_err(self, pids: np.ndarray) -> np.ndarray:
        """Per-request proxy stamp error for proxy indices ``pids``."""
        return self.eff()[self.n + np.asarray(pids)]

    def arr_err(self) -> np.ndarray:
        """Per-replica arrival-clock error, shape [n_replicas]."""
        return self.eff()[: self.n]

    def sigma_report(self, t: float) -> np.ndarray:
        """The honestly reported per-node bound at reference time ``t``."""
        return self.sigma + self.growth * np.maximum(0.0, t - self._sigma_t)

    def margin_sigmas(self, t: Optional[float] = None) -> tuple[float, float]:
        """(max proxy sigma, max replica sigma) -- DOM's sigma_S/sigma_R."""
        rep = self.sigma_report(self._t if t is None else t)
        sig_r = float(rep[: self.n].max())
        sig_s = float(rep[self.n:].max()) if self.n_proxies else sig_r
        return sig_s, sig_r

    # -- fault hooks (scenario events) --------------------------------------
    def set_outage(self, flag: bool) -> None:
        """Sync-daemon outage: probe rounds stop firing (interval ticks keep
        recording evidence with the grown bound) until restore."""
        if flag != self.outage:
            self.events.append({"kind": "outage" if flag else "restore",
                                "t": float(self._t)})
        self.outage = bool(flag)

    def set_probe_bias(self, observers, peers, bias: float) -> None:
        """Asymmetric-path attack/degradation: probes that ``observers``
        exchange with ``peers`` read ``bias`` seconds of extra offset."""
        if self.probe_bias is None:
            self.probe_bias = np.zeros((self.m, self.m))
        obs = np.asarray(list(observers), np.int64)
        prs = np.asarray(list(peers), np.int64)
        self.probe_bias[np.ix_(obs, prs)] = bias
        if not self.probe_bias.any():
            self.probe_bias = None

    def step(self, nodes, delta: float) -> None:
        """A true clock step (VM migration / leap) on ``nodes``."""
        self.offset[np.asarray(list(nodes), np.int64)] += delta

    # -- the epoch-boundary loop --------------------------------------------
    def advance(self, t_end: float) -> None:
        """Advance truth to ``t_end`` and queue any due probe round.

        Called once per epoch BEFORE the epoch's batches run. A round left
        pending by an epoch that never dispatched is applied first via the
        numpy twin, so corrections always land in the same epoch slot.
        """
        p = self.params
        while self._next_round <= t_end + 1e-12:
            t_r = self._next_round
            self.apply_pending()
            self._advance_truth(t_r)
            if self.outage:
                self._record(t_r)
            else:
                theta, rtt = self._sample_round()
                self.pending = (t_r, theta, rtt)
            self._next_round = t_r + float(p.sync_interval)
        self._advance_truth(t_end)

    def _advance_truth(self, t_end: float) -> None:
        dt = t_end - self._t
        if dt <= 0.0:
            return
        p = self.params
        self.offset += self.drift * dt
        if p.wander_sigma > 0.0:
            self.offset += self.rng.normal(
                0.0, p.wander_sigma * np.sqrt(dt), self.m)
        if p.step_rate > 0.0:
            hits = self.rng.poisson(p.step_rate * dt, self.m) > 0
            mags = self.rng.normal(0.0, p.step_sigma, self.m)
            self.offset += np.where(hits, mags, 0.0)
        self._t = float(t_end)

    def _sample_round(self) -> tuple[np.ndarray, np.ndarray]:
        """One probe burst against every peer, filtered to min-RTT samples.

        theta[i, p] = (eff_p - eff_i) + (d_fwd - d_back)/2 of the selected
        probe: the standard two-way NTP offset sample, biased by whatever
        asymmetry the fabric (or an installed probe bias) injects.
        """
        m = self.m
        nodes = np.arange(m)
        obs = np.broadcast_to(nodes[:, None], (m, m)).ravel()
        prs = np.broadcast_to(nodes[None, :], (m, m)).ravel()
        k = int(self.params.probes_per_peer)
        d_fwd = self.net.sample_probe_owd(obs, prs, k, self.probe_rng)
        d_back = self.net.sample_probe_owd(prs, obs, k, self.probe_rng)
        pick = np.argmin(d_fwd + d_back, axis=1)[:, None]
        d_f = np.take_along_axis(d_fwd, pick, axis=1)[:, 0].reshape(m, m)
        d_b = np.take_along_axis(d_back, pick, axis=1)[:, 0].reshape(m, m)
        rtt = d_f + d_b
        np.fill_diagonal(rtt, np.inf)      # no self-probes
        lost = ~np.isfinite(rtt)
        asym = (np.where(lost, 0.0, d_f) - np.where(lost, 0.0, d_b)) / 2.0
        eff = self.eff()
        theta = np.where(lost, 0.0, (eff[None, :] - eff[:, None]) + asym)
        if self.probe_bias is not None:
            theta = theta + self.probe_bias
        return theta, rtt

    def apply_pending(self) -> None:
        """Apply a pending round via the numpy twin of the in-body
        estimator (bit-identical to it)."""
        if self.pending is None:
            return
        p = self.params
        _, theta, rtt = self.pending
        est, sigma = estimate_offsets(theta, rtt, np,
                                      np.float64(p.sigma_safety),
                                      np.float64(p.sigma_floor))
        self.consume_round(est, sigma)

    def consume_round(self, est, sigma) -> None:
        """Fold one round's (est, sigma) -- computed in-program or by the
        numpy twin -- into corrections, bounds, and evidence."""
        assert self.pending is not None, "consume_round without a due round"
        t_r, _, rtt = self.pending
        # A node that heard NO peer this round (full outage of its links)
        # measured nothing: its est is 0 and its bound must keep growing
        # from the last real measurement, not reset to the floor.
        deaf = ~np.isfinite(rtt).any(axis=1)
        self.pending = None
        p = self.params
        est = np.asarray(est, np.float64)
        sigma = np.asarray(sigma, np.float64)
        # Evidence first, pre-correction: each row asserts "the bound
        # reported SINCE the last round covered the true offset" -- the
        # statement DOM relied on. A true step legitimately produces one
        # uncovered row (nothing can bound an unobserved leap); the
        # coverage check's confidence level absorbs it.
        self._record(t_r)
        prev = self.sigma_report(t_r)
        stepped = np.abs(est) > np.maximum(STEP_SIGMA_MULT * prev,
                                           STEP_FLOOR_MULT * p.sigma_floor)
        if self.rounds == 0:
            # The first measured round CALIBRATES the bound: pre-round sigma
            # is the configured bootstrap residual (tens of ns), far below
            # the probe estimator's own noise floor -- an honest first
            # correction is not a step.
            stepped &= False
        for i in np.flatnonzero(stepped):
            self.events.append({"kind": "step", "t": float(t_r),
                                "node": int(i),
                                "magnitude": float(est[i])})
        self.correction -= est
        # Two-round smoothing (the NTP clock-discipline flavor): MAD over a
        # handful of peers is noisy round-to-round; averaging with the
        # previous measurement stabilizes the bound without hiding real
        # degradation. A detected step overrides with the full correction
        # magnitude -- the bound must cover the residual until re-measured.
        meas = np.maximum(0.5 * (self.sigma + sigma), p.sigma_floor)
        meas = np.where(stepped, np.maximum(meas, np.abs(est)), meas)
        self.sigma = np.where(deaf, self.sigma, meas)
        self._sigma_t = np.where(deaf, self._sigma_t, float(t_r))
        self.rounds += 1

    def _record(self, t: float) -> None:
        eff = self.eff()
        err = eff - np.median(eff)
        self.evidence.append((float(t), err.copy(), self.sigma_report(t)))

    def evidence_columns(self) -> dict:
        """Flattened evidence for trace checkers: one row per
        (tick, node)."""
        if not self.evidence:
            return {}
        reps = len(self.evidence)
        return {
            "t": np.repeat(np.asarray([e[0] for e in self.evidence]), self.m),
            "node": np.tile(np.arange(self.m), reps),
            "err": np.concatenate([e[1] for e in self.evidence]),
            "sigma": np.concatenate([e[2] for e in self.evidence]),
            "events": list(self.events),
        }


__all__ = ["ClockSyncDaemon", "estimate_offsets",
           "TRUTH_SEED", "PROBE_SEED", "STAGGER_SEED",
           "STEP_SIGMA_MULT", "STEP_FLOOR_MULT"]
