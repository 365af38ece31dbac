"""Port of `repro/sim/network.py` (copied).

Cloud network model: per-path one-way delays, drops, and reordering.

S3 of the paper measures reordering on Google Cloud: messages multicast from
senders to two receivers arrive in different orders because each (sender,
receiver) path has independent, bursty delay. We model one-way delay (OWD) as
a shifted lognormal per path plus occasional burst excursions, which
reproduces the paper's 20-45% reordering scores at the measured send rates
(Figs 1-2) and lets DOM's percentile estimator do real work.

The same statistical model backs both an event-driven simulator (sampled
per message, the scalar API) and the vectorized data plane (sampled in
bulk).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass
class NetworkParams:
    """Statistical model of a single cloud zone's VM-to-VM fabric.

    Defaults approximate intra-zone Google Cloud (paper S9.1): median OWD
    ~65us, a heavy lognormal tail, rare multi-hundred-us bursts, tiny loss.
    """

    base_owd: float = 25e-6          # propagation + fixed host overhead (s)
    lognorm_mu: float = np.log(40e-6)  # median of the variable component
    lognorm_sigma: float = 0.55        # tail heaviness
    burst_prob: float = 0.015          # per-message chance of a burst excursion
    burst_scale: float = 350e-6        # mean extra delay in a burst (exponential)
    drop_prob: float = 1e-4            # per-message drop probability
    queue_us_per_inflight: float = 0.35e-6  # congestion: extra delay per in-flight msg on path
    path_offset_sigma: float = 8e-6    # per-(src,dst) persistent offset spread

    def scaled(self, factor: float) -> "NetworkParams":
        """Return params with the variable components scaled (for WAN etc.).

        Every *delay* component scales together: the fixed propagation term,
        the lognormal median, burst excursions, AND the per-path persistent
        offset spread -- the root cause of cross-path reordering (S3). An
        earlier version left ``path_offset_sigma`` at its intra-zone value,
        so scaled WAN-like profiles under-reordered at matched (rate x delay)
        operating points; tests/test_scenario.py pins the scale invariance of
        `reordering_score`. Probabilities (``burst_prob``, ``drop_prob``) are
        rates per message, not delays, and are left alone.
        """
        p = NetworkParams(**self.__dict__)
        p.base_owd *= factor
        p.lognorm_mu = float(np.log(np.exp(self.lognorm_mu) * factor))
        p.burst_scale *= factor
        p.path_offset_sigma *= factor
        return p


WAN_PARAMS = NetworkParams(
    base_owd=30e-3,
    lognorm_mu=float(np.log(2e-3)),
    lognorm_sigma=0.4,
    burst_prob=0.01,
    burst_scale=8e-3,
    drop_prob=3e-4,
    queue_us_per_inflight=0.35e-6,
    path_offset_sigma=2e-3,
)


class CloudNetwork:
    """Samples per-message OWDs/drops for (src, dst) node pairs.

    Nodes are integer ids. Each ordered path gets a persistent random offset
    (routes differ per path - the root cause of cloud reordering), plus iid
    lognormal jitter, burst excursions, and a simple congestion term driven
    by the number of in-flight messages on the path.
    """

    def __init__(self, n_nodes: int, params: Optional[NetworkParams] = None, seed: int = 0):
        self.n = n_nodes
        self.params = params or NetworkParams()
        self.rng = np.random.default_rng(seed)
        # Persistent per-path offsets: routes through different fabric paths.
        self._path_offset = self.rng.normal(
            0.0, self.params.path_offset_sigma, size=(n_nodes, n_nodes)
        ).clip(min=0.0)
        self._inflight = np.zeros((n_nodes, n_nodes), dtype=np.int64)
        self.n_sent = 0
        self.n_dropped = 0
        # Per-pair fault overrides (the adversarial fault family). Allocated
        # lazily on first use: the fault-free sampling paths below must
        # draw exactly the same random variates as before this feature
        # existed (bit-for-bit run reproducibility).
        self._pair_blocked: Optional[np.ndarray] = None   # bool [n, n]
        self._pair_drop: Optional[np.ndarray] = None      # extra P(drop)
        self._pair_mu: Optional[np.ndarray] = None        # extra-delay mean
        self._pair_sigma: Optional[np.ndarray] = None     # extra-delay spread

    # -- per-pair fault overrides (partitions / gray links) -------------------
    @property
    def pair_faults_active(self) -> bool:
        return self._pair_blocked is not None

    @property
    def gray_active(self) -> bool:
        """True while any gray-link override (delay or drop) is installed."""
        return self._pair_drop is not None and bool(
            self._pair_drop.any() or self._pair_mu.any()
            or self._pair_sigma.any())

    def _ensure_pair_state(self) -> None:
        if self._pair_blocked is None:
            self._pair_blocked = np.zeros((self.n, self.n), bool)
            self._pair_drop = np.zeros((self.n, self.n))
            self._pair_mu = np.zeros((self.n, self.n))
            self._pair_sigma = np.zeros((self.n, self.n))

    def _maybe_release_pair_state(self) -> None:
        """Drop override state when every override is cleared, restoring the
        exact fault-free sampling path (no extra rng draws)."""
        if self._pair_blocked is not None and not self._pair_blocked.any() \
                and not self._pair_drop.any() and not self._pair_mu.any() \
                and not self._pair_sigma.any():
            self._pair_blocked = None
            self._pair_drop = None
            self._pair_mu = None
            self._pair_sigma = None

    def set_partition(self, groups) -> None:
        """Block every path between nodes in different ``groups`` (node-id
        lists); within-group paths are untouched. Replaces any previous
        partition."""
        self._ensure_pair_state()
        side = np.full(self.n, -1, np.int64)
        for gi, g in enumerate(groups):
            side[np.asarray(list(g), np.int64)] = gi
        blocked = (side[:, None] != side[None, :]) & \
                  (side[:, None] >= 0) & (side[None, :] >= 0)
        self._pair_blocked = blocked

    def clear_partition(self) -> None:
        if self._pair_blocked is not None:
            self._pair_blocked[:] = False
            self._maybe_release_pair_state()

    def set_gray_pairs(self, a, b, delay_mu: float = 0.0,
                       delay_sigma: float = 0.0, drop_prob: float = 0.0) -> None:
        """Install a gray fault on every path between node sets ``a`` and
        ``b`` (both directions): extra N(mu, sigma) delay (clipped at 0)
        and/or extra drop probability."""
        self._ensure_pair_state()
        a = np.asarray(list(a), np.int64)
        b = np.asarray(list(b), np.int64)
        for rows, cols in ((a, b), (b, a)):
            self._pair_drop[np.ix_(rows, cols)] = drop_prob
            self._pair_mu[np.ix_(rows, cols)] = delay_mu
            self._pair_sigma[np.ix_(rows, cols)] = delay_sigma

    def clear_gray_pairs(self, a, b) -> None:
        if self._pair_drop is None:
            return
        a = np.asarray(list(a), np.int64)
        b = np.asarray(list(b), np.int64)
        for rows, cols in ((a, b), (b, a)):
            self._pair_drop[np.ix_(rows, cols)] = 0.0
            self._pair_mu[np.ix_(rows, cols)] = 0.0
            self._pair_sigma[np.ix_(rows, cols)] = 0.0
        self._maybe_release_pair_state()

    def clear_gray_all(self) -> None:
        if self._pair_drop is not None:
            self._pair_drop[:] = 0.0
            self._pair_mu[:] = 0.0
            self._pair_sigma[:] = 0.0
            self._maybe_release_pair_state()

    def set_params(self, params: NetworkParams) -> None:
        """Switch to a new statistical regime mid-run (scenario `NetShift`).

        Per-path persistent offsets are re-drawn from the new spread --
        a regime shift reroutes paths, it does not rescale the old routes.
        """
        self.params = params
        self._path_offset = self.rng.normal(
            0.0, params.path_offset_sigma, size=(self.n, self.n)
        ).clip(min=0.0)

    # -- scalar API (event-driven simulator) --------------------------------
    def sample_owd(self, src: int, dst: int) -> Optional[float]:
        """One-way delay in seconds, or None if the message is dropped."""
        p = self.params
        self.n_sent += 1
        if self._pair_blocked is not None:
            if self._pair_blocked[src, dst]:
                self.n_dropped += 1
                return None
            xd = self._pair_drop[src, dst]
            if xd > 0.0 and self.rng.random() < xd:
                self.n_dropped += 1
                return None
        if self.rng.random() < p.drop_prob:
            self.n_dropped += 1
            return None
        d = p.base_owd + self._path_offset[src, dst]
        d += self.rng.lognormal(p.lognorm_mu, p.lognorm_sigma)
        if self.rng.random() < p.burst_prob:
            d += self.rng.exponential(p.burst_scale)
        d += p.queue_us_per_inflight * float(self._inflight[src, dst])
        if self._pair_mu is not None:
            mu, sg = self._pair_mu[src, dst], self._pair_sigma[src, dst]
            if mu > 0.0 or sg > 0.0:
                d += max(0.0, self.rng.normal(mu, sg))
        return float(d)

    def on_send(self, src: int, dst: int) -> None:
        self._inflight[src, dst] += 1

    def on_deliver(self, src: int, dst: int) -> None:
        self._inflight[src, dst] = max(0, self._inflight[src, dst] - 1)

    # -- bulk API (vectorized Monte-Carlo) -----------------------------------
    def sample_owd_matrix(
        self, srcs: np.ndarray, n_msgs: int, dsts: Sequence[int]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Sample OWDs for n_msgs messages from srcs[i] to every dst.

        Returns (owd[n_msgs, n_dsts] seconds, dropped[n_msgs, n_dsts] bool).
        Congestion term omitted in bulk mode (rate effects are injected by the
        caller via the workload's send-rate -> burst_prob mapping).
        """
        p = self.params
        n_dsts = len(dsts)
        srcs = np.asarray(srcs)
        dsts_a = np.asarray(dsts)
        owd = np.full((n_msgs, n_dsts), p.base_owd)
        owd += self._path_offset[srcs[:, None], dsts_a[None, :]]
        owd += self.rng.lognormal(p.lognorm_mu, p.lognorm_sigma, size=(n_msgs, n_dsts))
        bursts = self.rng.random((n_msgs, n_dsts)) < p.burst_prob
        owd += np.where(bursts, self.rng.exponential(p.burst_scale, size=(n_msgs, n_dsts)), 0.0)
        dropped = self.rng.random((n_msgs, n_dsts)) < p.drop_prob
        if self._pair_blocked is not None:
            ix = (srcs[:, None], dsts_a[None, :])
            mu, sg = self._pair_mu[ix], self._pair_sigma[ix]
            if mu.any() or sg.any():
                extra = self.rng.normal(mu, sg).clip(min=0.0)
                owd += np.where((mu > 0.0) | (sg > 0.0), extra, 0.0)
            xd = self._pair_drop[ix]
            if xd.any():
                dropped |= self.rng.random((n_msgs, n_dsts)) < xd
            dropped |= self._pair_blocked[ix]
        return owd, dropped

    def sample_probe_owd(self, srcs: np.ndarray, dsts: np.ndarray,
                         k: int, rng: np.random.Generator) -> np.ndarray:
        """OWDs for ``k`` sync probes on each path srcs[i] -> dsts[i].

        The clock-sync daemon's probe traffic (repro_torch.core.clocksync): the
        probes traverse the same fabric statistics as data messages --
        persistent per-path offsets (the asymmetry the NTP-style estimator
        must survive), lognormal jitter, bursts, drops, and any installed
        partition/gray overrides -- but every draw comes from the CALLER's
        ``rng``. The network's own stream is never consumed, so arming the
        sync daemon cannot perturb data-plane sampling (bit-for-bit run
        reproducibility, the same contract as the pair-fault overrides).

        Returns owd[n_pairs, k] in seconds with +inf marking lost probes
        (dropped or blocked); callers treat non-finite RTTs as invalid.
        """
        p = self.params
        srcs = np.asarray(srcs)
        dsts = np.asarray(dsts)
        n = srcs.size
        owd = np.full((n, k), p.base_owd)
        owd += self._path_offset[srcs, dsts][:, None]
        owd += rng.lognormal(p.lognorm_mu, p.lognorm_sigma, size=(n, k))
        bursts = rng.random((n, k)) < p.burst_prob
        owd += np.where(bursts, rng.exponential(p.burst_scale, size=(n, k)),
                        0.0)
        lost = rng.random((n, k)) < p.drop_prob
        if self._pair_blocked is not None:
            mu = self._pair_mu[srcs, dsts][:, None]
            sg = self._pair_sigma[srcs, dsts][:, None]
            if mu.any() or sg.any():
                extra = rng.normal(np.broadcast_to(mu, (n, k)),
                                   np.broadcast_to(sg, (n, k))).clip(min=0.0)
                owd += np.where((mu > 0.0) | (sg > 0.0), extra, 0.0)
            xd = self._pair_drop[srcs, dsts][:, None]
            if xd.any():
                lost |= rng.random((n, k)) < xd
            lost |= self._pair_blocked[srcs, dsts][:, None]
        return np.where(lost, np.inf, owd)

    def sample_owd_pairs(
        self, srcs: np.ndarray, dsts: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Paired bulk sampling: one OWD per message i for srcs[i] -> dsts[i].

        Unlike `sample_owd_matrix` (every message to every dst), each message
        here has its own destination -- e.g. proxy->client replies, where the
        reply goes to the *actual* submitting client. Returns
        (owd[n] seconds, dropped[n] bool). Same statistical model and
        bulk-mode caveats as `sample_owd_matrix`.
        """
        p = self.params
        srcs = np.asarray(srcs)
        dsts = np.asarray(dsts)
        n = srcs.size
        owd = np.full(n, p.base_owd)
        owd += self._path_offset[srcs, dsts]
        owd += self.rng.lognormal(p.lognorm_mu, p.lognorm_sigma, size=n)
        bursts = self.rng.random(n) < p.burst_prob
        owd += np.where(bursts, self.rng.exponential(p.burst_scale, size=n), 0.0)
        dropped = self.rng.random(n) < p.drop_prob
        if self._pair_blocked is not None:
            mu, sg = self._pair_mu[srcs, dsts], self._pair_sigma[srcs, dsts]
            if mu.any() or sg.any():
                extra = self.rng.normal(mu, sg).clip(min=0.0)
                owd += np.where((mu > 0.0) | (sg > 0.0), extra, 0.0)
            xd = self._pair_drop[srcs, dsts]
            if xd.any():
                dropped |= self.rng.random(n) < xd
            dropped |= self._pair_blocked[srcs, dsts]
        return owd, dropped


# ---------------------------------------------------------------------------
# Reordering metric (S3): LIS-based reordering score.
# ---------------------------------------------------------------------------
def lis_length(seq: np.ndarray) -> int:
    """Length of the longest increasing subsequence. O(n log n) patience sort."""
    import bisect

    tails: list = []
    for x in np.asarray(seq).tolist():
        i = bisect.bisect_left(tails, x)
        if i == len(tails):
            tails.append(x)
        else:
            tails[i] = x
    return len(tails)


def reordering_score(reference_order: np.ndarray, observed_order: np.ndarray) -> float:
    """Paper S3: 1 - LIS(observed-with-reference-ranks)/len, in percent.

    reference_order: message ids in the order R1 received them (ground truth).
    observed_order:  message ids in the order R2 received them.
    Messages missing from either sequence are ignored (drops are not
    reordering).
    """
    ref_rank = {int(m): i for i, m in enumerate(np.asarray(reference_order).tolist())}
    ranks = [ref_rank[int(m)] for m in np.asarray(observed_order).tolist() if int(m) in ref_rank]
    if not ranks:
        return 0.0
    return (1.0 - lis_length(np.asarray(ranks)) / len(ranks)) * 100.0


__all__ = ["NetworkParams", "CloudNetwork", "WAN_PARAMS", "lis_length", "reordering_score"]
