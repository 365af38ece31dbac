"""Port of `repro/sim/scenario.py`: the scenario API -- declarative
environment + fault-schedule + workload specs -- and the named catalog of
the paper's experiment surface.

The paper's headline claim is that Nezha's edge survives hostile cloud
conditions -- bursty reordering-prone paths (S3), WAN deployments (Fig 13),
replica failure/recovery (Figs 14-15), and badly synchronized clocks
(Appendix D). A `Scenario` captures one such condition declaratively:

  environment   a named network profile (``gcp-intra-zone``, ``multi-zone``,
                ``wan``, ``lossy``, ``congested``) plus a clock regime
                (``synced``, ``drifty``, ``skewed``) and environment-specific
                protocol tuning (e.g. WAN timeouts);
  faults        a typed, timestamped schedule of `FaultEvent`s -- `Crash`,
                `Relaunch`, `ClockFault`, `ClockClear`, `NetShift`, plus the
                adversarial network and clock-sync families below;
  workload      a `repro_torch.sim.workload.Workload` (open/closed loop,
                rate, duration, key skew, read ratio).

Fault vocabulary (event -> detecting invariant in `repro_torch.sim.trace`):

  ==================  =======================================
  event               detecting invariant
  ==================  =======================================
  Crash / Relaunch    check_durable_log
  ClockFault/-Clear   check_deadline_order
  NetShift            check_trace (regression suite)
  Partition / Heal    check_partition_liveness: majority side keeps
                      committing, the isolated side provably does not
  GrayLink/GrayClear  check_partition_liveness (gray windows): fast-path
                      ratio / commit-rate collapse inside the window
  SkewedStamper       check_stamp_bias: per-proxy deadline offset
                      estimator beyond sync error
  LossyAcker          check_durability (acked-but-unpersisted prefix
                      exposed at relaunch) and check_split_brain
  SyncOutage/-Restore check_sync_degraded
  SyncBias            check_sync_degraded
  ClockLeap           check_sync_step
  ==================  =======================================

One entry point runs any scenario:

    from repro_torch.sim.scenario import run_scenario
    result = run_scenario("nezha-vectorized", "leader-crash")

`run_scenario` builds the protocol's config from the scenario (environment
fields + overrides that the config class actually declares), schedules the
fault events through `Cluster.schedule_fault`, drives the workload, and
returns a `ScenarioResult` with one fixed summary schema. The run goes on
the card unless the caller passes ``device="cpu"`` (the plain versions of
the DOM kernels), as `VectorizedConfig.device` does. The port registers
one backend, ``nezha-vectorized``; any other name fails in the registry
with the names that are available. Fault events the backend cannot model
(a `GroupFault` on a single-group backend: a multi-group scenario runs its
single-group projection) are skipped and counted in
``ScenarioResult.skipped_faults`` instead of raising mid-run.
`VectorizedNezhaCluster.schedule_fault` resolves the events' node
selectors through `_link_nodes` and `_clock_targets` below.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Union

import numpy as np

from repro_torch.core.clock import ClockParams
from repro_torch.sim.network import WAN_PARAMS, NetworkParams
from repro_torch.sim.workload import Workload, WorkloadDriver

# ---------------------------------------------------------------------------
# Environments: named network profiles x clock regimes
# ---------------------------------------------------------------------------
NET_PROFILES: dict[str, NetworkParams] = {
    # Intra-zone Google Cloud (paper S9.1): the calibrated default fabric.
    "gcp-intra-zone": NetworkParams(),
    # Zones in one region: every delay component scaled together (S9.8's
    # multi-zone placement); `scaled` now also scales the per-path offset
    # spread, the root cause of cross-path reordering.
    "multi-zone": NetworkParams().scaled(6.0),
    # Cross-region WAN (Fig 13): tens-of-ms OWDs, ms-scale path spread.
    "wan": WAN_PARAMS,
    # Lossy fabric: two orders of magnitude more drops than intra-zone.
    "lossy": NetworkParams(drop_prob=1e-2),
    # Congested fabric: frequent burst excursions + strong queueing.
    "congested": NetworkParams(burst_prob=0.25, burst_scale=500e-6,
                               queue_us_per_inflight=1.5e-6),
}

CLOCK_REGIMES: dict[str, ClockParams] = {
    # Huygens steady state (paper S2.1): tens-of-ns residuals.
    "synced": ClockParams(),
    # Rarely resynchronized crystals under the MODELED sync loop:
    # per-node drift + wander truth, periodic multi-peer probe rounds
    # through the fabric, and measured error bounds feeding DOM's margin.
    "drifty": ClockParams(drift_ppm_sigma=50.0, resync_interval=10.0,
                          sync_model=True),
    # Badly synchronized clocks (Appendix D regime): us-scale residuals.
    "skewed": ClockParams(residual_sigma=5e-6),
}


@dataclass(frozen=True)
class Environment:
    """Deployment conditions: fabric statistics + clock sync quality.

    ``overrides`` carries environment-specific protocol tuning (timeouts,
    DOM clamp, batching cadence...). Each override is applied to a protocol's
    config only if that config class declares the field (directly, or on its
    nested ``replica``/``dom`` params) -- so one environment parameterizes
    every config family without leaking knobs
    across families.
    """

    name: str
    net_profile: str = "gcp-intra-zone"
    clock_regime: str = "synced"
    overrides: dict = field(default_factory=dict)
    description: str = ""

    @property
    def net(self) -> NetworkParams:
        return NET_PROFILES[self.net_profile]

    @property
    def clock(self) -> ClockParams:
        return CLOCK_REGIMES[self.clock_regime]


# WAN tuning mirrors Fig 13's deployment: proxies co-located with clients
# (LAN hop), second-scale client timeout, ms-scale DOM clamp and batching.
_WAN_DOM = dict(percentile=50.0, window=200, beta=3.0, clamp_d=80e-3,
                initial_owd=40e-3)

ENVIRONMENTS: dict[str, Environment] = {
    e.name: e for e in (
        Environment("gcp-intra-zone",
                    description="calibrated intra-zone GCP fabric, synced clocks"),
        Environment("multi-zone", net_profile="multi-zone",
                    overrides=dict(client_timeout=40e-3),
                    description="zones in one region: 6x delay + path spread"),
        Environment("wan", net_profile="wan",
                    overrides=dict(
                        client_timeout=400e-3,
                        dom=_WAN_DOM,
                        batch_interval=2e-3, status_interval=10e-3,
                        commit_interval=50e-3, heartbeat_timeout=500e-3,
                        client_proxy_lan=150e-6),
                    description="Fig 13: replicas across regions, proxies in "
                                "the client zone"),
        Environment("lossy", net_profile="lossy",
                    description="1% message loss"),
        Environment("congested", net_profile="congested",
                    description="bursty, queue-heavy fabric"),
        Environment("drifty-clocks", clock_regime="drifty",
                    description="intra-zone fabric, rarely resynced clocks"),
        Environment("skewed-clocks", clock_regime="skewed",
                    description="intra-zone fabric, us-scale sync residuals"),
    )
}


# ---------------------------------------------------------------------------
# Fault events: typed, timestamped
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultEvent:
    """A timestamped fault. ``kind`` lets backends dispatch without importing
    this module (no core -> sim.scenario dependency)."""

    t: float
    kind = "abstract"


@dataclass(frozen=True)
class Crash(FaultEvent):
    rid: int = 0
    kind = "crash"


@dataclass(frozen=True)
class Relaunch(FaultEvent):
    rid: int = 0
    kind = "relaunch"


@dataclass(frozen=True)
class ClockFault(FaultEvent):
    """Inject N(mu, sigma) into clock reads of ``who`` from time ``t`` on
    (Appendix D). ``who`` selects the clocks:

      "leader"        the initial leader replica (replica 0)
      "replica:<i>"   replica i
      "proxy:<i>"     proxy i
      "proxies"       every proxy
      "replicas"      every replica

    The vectorized backend routes this to its engine's per-node
    stamp/arrival clock offsets in the vectorized engine).
    """

    who: str = "leader"
    mu: float = 0.0
    sigma: float = 0.0
    kind = "clock-fault"

    def targets(self, n_replicas: int, n_proxies: int) -> list[tuple[str, int]]:
        return _clock_targets(self.who, n_replicas, n_proxies)


@dataclass(frozen=True)
class ClockClear(FaultEvent):
    """Remove any injected clock fault from ``who`` (same selector syntax)."""

    who: str = "leader"
    kind = "clock-clear"

    def targets(self, n_replicas: int, n_proxies: int) -> list[tuple[str, int]]:
        return _clock_targets(self.who, n_replicas, n_proxies)


@dataclass(frozen=True)
class NetShift(FaultEvent):
    """Switch the fabric to another named network profile at time ``t``
    (e.g. an intra-zone deployment degrading to 'congested')."""

    profile: str = "gcp-intra-zone"
    kind = "net-shift"

    @property
    def params(self) -> NetworkParams:
        return NET_PROFILES[self.profile]


@dataclass(frozen=True)
class Partition(FaultEvent):
    """Network partition: replicas in different ``groups`` cannot exchange
    messages from ``t`` until a later `Heal`. ``groups`` must cover every
    replica id exactly once. Proxies and clients stay with the ``main``
    group (-1 = the largest group, first on ties); replicas outside the
    main group are unreachable from proxies, clients AND main-side
    replicas -- the classic "is the leader dead or just cut off?"
    ambiguity a failure detector cannot resolve."""

    groups: tuple = ((0,), (1, 2))
    main: int = -1
    kind = "partition"

    def main_group(self) -> int:
        if self.main >= 0:
            return int(self.main)
        sizes = [len(g) for g in self.groups]
        return int(max(range(len(sizes)), key=lambda i: (sizes[i], -i)))

    def minority(self) -> tuple:
        """Replica ids NOT on the proxy/client side of the cut."""
        m = self.main_group()
        out: list[int] = []
        for i, g in enumerate(self.groups):
            if i != m:
                out.extend(int(r) for r in g)
        return tuple(sorted(out))


@dataclass(frozen=True)
class Heal(FaultEvent):
    """Remove the currently open `Partition` (all groups reconnect)."""

    kind = "heal"


@dataclass(frozen=True)
class GrayLink(FaultEvent):
    """Gray failure on the links between ``src`` and ``dst`` endpoints:
    extra N(delay_mu, delay_sigma)-distributed delay (clipped at 0) and/or
    an extra per-message ``drop_prob``, both directions, from ``t`` until a
    matching `GrayClear`. The link neither dies nor recovers -- it lies.

    Endpoint selectors: ``"replica:<i>"`` / ``"proxy:<i>"`` /
    ``"replicas"`` / ``"proxies"`` / ``"*"``; a bare int means
    ``replica:<i>``."""

    src: Union[int, str] = "*"
    dst: Union[int, str] = "*"
    delay_mu: float = 0.0
    delay_sigma: float = 0.0
    drop_prob: float = 0.0
    kind = "gray-link"


@dataclass(frozen=True)
class GrayClear(FaultEvent):
    """Clear the gray fault previously installed on (``src``, ``dst``);
    the default ``("*", "*")`` clears every open gray link."""

    src: Union[int, str] = "*"
    dst: Union[int, str] = "*"
    kind = "gray-clear"


@dataclass(frozen=True)
class SkewedStamper(FaultEvent):
    """Byzantine-leaning proxy: from ``t`` on, proxy ``proxy_id`` stamps
    send-times (and therefore deadlines) shifted by ``bias`` seconds. Its
    messages also poison the receiver-side OWD measurements by ``-bias``,
    exactly as a lying clock read would. Sticky until the end of the run."""

    proxy_id: int = 0
    bias: float = 0.0
    kind = "skewed-stamper"


@dataclass(frozen=True)
class LossyAcker(FaultEvent):
    """Byzantine-leaning replica: from ``t`` on, replica ``rid`` keeps
    acknowledging entries without durably persisting them. Invisible while
    the replica stays up; a later `Crash` + `Relaunch` exposes the
    acked-but-unpersisted suffix (the replica restarts trusting its
    truncated durable log)."""

    rid: int = 0
    kind = "lossy-acker"


@dataclass(frozen=True)
class SyncOutage(FaultEvent):
    """The clock-sync daemon stops running probe rounds at ``t`` (crashed /
    unreachable NTP fleet): clocks keep drifting unobserved and the honestly
    reported error bound GROWS until a `SyncRestore`. Only regimes with a
    modeled sync loop (``ClockParams.sync_model``) can exhibit it."""

    kind = "sync-outage"


@dataclass(frozen=True)
class SyncRestore(FaultEvent):
    """Probe rounds resume after a `SyncOutage`: the estimator re-measures
    and the reported bound narrows back toward the synced-era value."""

    kind = "sync-restore"


@dataclass(frozen=True)
class SyncBias(FaultEvent):
    """Asymmetric-path probe bias: sync probes that the ``src`` clocks
    exchange with the ``dst`` clocks read ``bias`` extra seconds of offset
    (a congested/rerouted forward path the two-way exchange cannot cancel).
    Selectors use the clock syntax ('leader', 'replicas', 'proxies',
    'replica:<i>', 'proxy:<i>') plus 'all' for the whole synchronized
    fleet; ``bias=0`` clears the pairs."""

    src: str = "all"
    dst: str = "all"
    bias: float = 0.0
    kind = "sync-bias"


@dataclass(frozen=True)
class ClockLeap(FaultEvent):
    """A TRUE clock step on ``who`` at ``t`` (VM migration / leap second):
    the clock's offset jumps by ``delta`` seconds and only the next probe
    round can notice. Selector syntax matches `ClockFault.who`."""

    who: str = "leader"
    delta: float = 0.0
    kind = "clock-leap"

    def targets(self, n_replicas: int, n_proxies: int) -> list[tuple[str, int]]:
        return _clock_targets(self.who, n_replicas, n_proxies)


@dataclass(frozen=True)
class GroupFault:
    """Address a fault event to ONE consensus group of a sharded backend
    (``nezha-sharded``): the wrapped ``event`` is scheduled on group
    ``group`` with group-local replica/proxy ids. Backends without groups
    cannot model it (skipped-and-counted, like any unsupported event).

    Not a `FaultEvent` subclass -- the timestamp belongs to the wrapped
    event; ``t`` delegates so schedule sorting and horizon validation see
    the inner time."""

    group: int
    event: FaultEvent
    kind = "group-fault"

    @property
    def t(self) -> float:
        return self.event.t


NET_FAULT_KINDS = ("partition", "heal", "gray-link", "gray-clear")


def _link_nodes(sel, n_replicas: int, n_proxies: int) -> tuple[tuple, tuple]:
    """Resolve a gray-link endpoint selector to (replica_ids, proxy_ids).

    Range-checked here (schedule/validation time) like `_clock_targets`:
    a bad endpoint must fail loudly, not silently gray out a neighbor."""
    if isinstance(sel, (int, np.integer)):
        sel = f"replica:{int(sel)}"
    if sel == "*":
        return tuple(range(n_replicas)), tuple(range(n_proxies))
    if sel == "replicas":
        return tuple(range(n_replicas)), ()
    if sel == "proxies":
        return (), tuple(range(n_proxies))
    role, _, idx = str(sel).partition(":")
    if role in ("replica", "proxy") and idx.isdigit():
        n = n_replicas if role == "replica" else n_proxies
        if int(idx) >= n:
            raise ValueError(
                f"gray-link endpoint {sel!r} out of range: "
                f"cluster has {n} {role} node(s)")
        return ((int(idx),), ()) if role == "replica" else ((), (int(idx),))
    raise ValueError(
        f"bad gray-link endpoint {sel!r}; expected 'replica:<i>', "
        "'proxy:<i>', 'replicas', 'proxies' or '*'")


def _clock_targets(who: str, n_replicas: int, n_proxies: int) -> list[tuple[str, int]]:
    if who == "leader":
        return [("replica", 0)]
    if who == "replicas":
        return [("replica", i) for i in range(n_replicas)]
    if who == "proxies":
        return [("proxy", i) for i in range(n_proxies)]
    role, _, idx = who.partition(":")
    if role in ("replica", "proxy") and idx.isdigit():
        # Range-checked here, where the cluster's shape is known: an
        # out-of-range index must fail at schedule time on EVERY backend,
        # not silently fault a neighboring node's clock mid-run.
        n = n_replicas if role == "replica" else n_proxies
        if int(idx) >= n:
            raise ValueError(
                f"clock-fault selector {who!r} out of range: "
                f"cluster has {n} {role} node(s)")
        return [(role, int(idx))]
    raise ValueError(
        f"bad clock-fault selector {who!r}; expected 'leader', 'replicas', "
        "'proxies', 'replica:<i>' or 'proxy:<i>'")


# ---------------------------------------------------------------------------
# Scenario + result
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Scenario:
    """One declarative experiment: environment x fault schedule x workload.

    ``overrides`` extends/overrides the environment's protocol tuning (same
    field-matching rules); ``f``/``n_clients``/``seed`` parameterize the
    shared `CommonConfig` core.
    """

    name: str
    environment: Union[str, Environment] = "gcp-intra-zone"
    faults: tuple = ()
    workload: Workload = field(default_factory=Workload)
    f: int = 1
    n_clients: int = 10
    seed: int = 0
    overrides: dict = field(default_factory=dict)
    description: str = ""
    # Consensus groups (sharded Nezha): > 1 targets the `nezha-sharded`
    # backend, whose config declares the knob; single-group backends simply
    # never see it (build_config's field-matching rule). Fault events
    # address groups via `GroupFault`.
    groups: int = 1
    # Name of the `repro_torch.sim.trace` detection invariant paired with
    # this scenario's fault schedule (key into trace.ADVERSARIAL_CHECKS), or
    # None. The paired invariant must fire on the faulty schedule and stay
    # silent on the fault-free control.
    invariant: Optional[str] = None

    def __post_init__(self):
        _validate_scenario(self)

    def control(self) -> "Scenario":
        """The fault-free control run: same environment/workload, no faults
        (the paired invariant must stay silent on it)."""
        return replace(self, name=f"{self.name}-control", faults=(),
                       invariant=None)

    @property
    def env(self) -> Environment:
        if isinstance(self.environment, Environment):
            return self.environment
        return ENVIRONMENTS[self.environment]

    @property
    def horizon(self) -> float:
        """Run horizon: workload duration plus drain. Fault events must land
        inside it (enforced at construction)."""
        return float(self.workload.duration) + float(self.workload.drain)


def _validate_scenario(sc: Scenario) -> None:
    """Static validation at construction time: a malformed scenario fails
    with a clear error HERE, not as a silent no-op (event past the horizon)
    or an obscure backend crash minutes into a sweep."""
    errs: list[str] = []
    if sc.f < 1:
        errs.append(f"f={sc.f}: Nezha needs f >= 1 (2f+1 replicas)")
    if sc.groups < 1:
        errs.append(f"groups={sc.groups}: needs >= 1 consensus group")
    w = sc.workload
    if not (0.0 <= w.multiop_ratio <= 1.0):
        errs.append(f"workload multiop_ratio={w.multiop_ratio!r} "
                    "outside [0, 1]")
    if w.multiop_ratio > 0.0 and w.multiop_span < 2:
        errs.append(f"workload multiop_span={w.multiop_span} < 2: a "
                    "multi-key op needs at least two keys")
    n = 2 * sc.f + 1
    n_over = sc.overrides.get("n_replicas")
    if n_over is not None and n_over < n:
        errs.append(f"n_replicas override {n_over} < 2f+1 = {n}: "
                    "quorums cannot form")
    if isinstance(sc.environment, str) and sc.environment not in ENVIRONMENTS:
        errs.append(f"unknown environment {sc.environment!r}; available: "
                    + ", ".join(ENVIRONMENTS))
    horizon = sc.horizon
    # The proxy count, where known, range-checks SkewedStamper/GrayLink
    # proxy endpoints at construction time; without an override the config
    # default (1 proxy) applies.
    n_prox = sc.overrides.get("n_proxies")
    if n_prox is None:
        try:
            n_prox = sc.env.overrides.get("n_proxies", 1)
        except KeyError:
            n_prox = 1
    # replicas currently down (crashed, not yet relaunched), in schedule
    # order -- stable sort keeps same-t events in declaration order, so a
    # same-instant crash+relaunch pair is only legal crash-first
    down: set = set()
    partition_open = False          # Partition seen, no Heal yet
    gray_open: dict[tuple, int] = {}  # (src, dst) -> open GrayLink count
    sync_outage_open = False        # SyncOutage seen, no SyncRestore yet
    for ev in sorted(sc.faults, key=lambda e: e.t):
        tag = f"{type(ev).__name__}(t={ev.t!r})"
        if not (0.0 <= ev.t <= horizon):
            errs.append(f"{tag} outside the run horizon [0, {horizon!r}] "
                        "(duration + drain): it would never fire")
        kind = getattr(ev, "kind", "abstract")
        if kind == "group-fault":
            # validated against the scenario's group count and GROUP-LOCAL
            # replica ids; the wrapped event is checked for basic sanity
            # only (per-group crash/relaunch pairing is not tracked here)
            if not (0 <= ev.group < sc.groups):
                errs.append(f"{tag}: group={ev.group} out of range for "
                            f"{sc.groups} group(s)")
            inner = getattr(ev, "event", None)
            ikind = getattr(inner, "kind", "abstract")
            if ikind in ("crash", "relaunch"):
                rid = getattr(inner, "rid", 0)
                if not (0 <= rid < n):
                    errs.append(f"{tag}: group-local rid={rid} out of range "
                                f"for 2f+1 = {n} replicas per group")
            continue
        if kind == "partition":
            if partition_open:
                errs.append(f"{tag}: a partition is already open "
                            "(overlapping partitions need a Heal between)")
            partition_open = True
            groups = getattr(ev, "groups", ())
            flat: list[int] = []
            for g in groups:
                flat.extend(int(r) for r in g)
            if len(groups) < 2 or any(len(g) == 0 for g in groups):
                errs.append(f"{tag}: needs >= 2 non-empty groups")
            if len(flat) != len(set(flat)):
                errs.append(f"{tag}: groups overlap (a replica appears in "
                            "two groups)")
            if set(flat) != set(range(n)):
                errs.append(f"{tag}: groups must cover every replica id "
                            f"0..{n - 1} exactly once, got {sorted(set(flat))}")
            if not (-1 <= ev.main < len(groups)):
                errs.append(f"{tag}: main={ev.main} is not a group index")
        elif kind == "heal":
            if not partition_open:
                errs.append(f"{tag}: Heal with no open Partition before it")
            partition_open = False
        elif kind == "gray-link":
            for sel in (ev.src, ev.dst):
                try:
                    _link_nodes(sel, n, n_prox)
                except ValueError as exc:
                    errs.append(f"{tag}: {exc}")
            if not (ev.delay_mu >= 0.0 and ev.delay_sigma >= 0.0
                    and np.isfinite(ev.delay_mu) and np.isfinite(ev.delay_sigma)):
                errs.append(f"{tag}: delay_mu/delay_sigma must be finite "
                            "and >= 0")
            if not (0.0 <= ev.drop_prob <= 1.0):
                errs.append(f"{tag}: drop_prob={ev.drop_prob!r} outside [0, 1]")
            if ev.delay_mu == 0.0 and ev.delay_sigma == 0.0 \
                    and ev.drop_prob == 0.0:
                errs.append(f"{tag}: no effect (delay and drop all zero)")
            key = (ev.src, ev.dst)
            gray_open[key] = gray_open.get(key, 0) + 1
        elif kind == "gray-clear":
            for sel in (ev.src, ev.dst):
                try:
                    _link_nodes(sel, n, n_prox)
                except ValueError as exc:
                    errs.append(f"{tag}: {exc}")
            key = (ev.src, ev.dst)
            if key == ("*", "*"):
                if not any(gray_open.values()):
                    errs.append(f"{tag}: GrayClear with no open GrayLink "
                                "before it")
                gray_open.clear()
            elif gray_open.get(key, 0) <= 0:
                errs.append(f"{tag}: GrayClear({ev.src!r}, {ev.dst!r}) "
                            "matches no open GrayLink")
            else:
                gray_open[key] -= 1
        elif kind == "skewed-stamper":
            if not (0 <= ev.proxy_id < n_prox):
                errs.append(f"{tag}: proxy_id={ev.proxy_id} out of range for "
                            f"{n_prox} proxy node(s)")
            if not np.isfinite(ev.bias):
                errs.append(f"{tag}: bias must be finite")
        elif kind == "lossy-acker":
            if not (0 <= ev.rid < n):
                errs.append(f"{tag}: rid={ev.rid} out of range for "
                            f"2f+1 = {n} replicas")
        elif kind in ("crash", "relaunch"):
            rid = getattr(ev, "rid", 0)
            if not (0 <= rid < n):
                errs.append(f"{tag}: rid={rid} out of range for "
                            f"2f+1 = {n} replicas")
            elif kind == "crash":
                if rid in down:
                    errs.append(f"{tag}: replica {rid} is already down")
                down.add(rid)
            elif rid not in down:
                errs.append(f"{tag}: relaunch of replica {rid} with no "
                            "preceding crash")
            else:
                down.discard(rid)
        elif kind == "sync-outage":
            if sync_outage_open:
                errs.append(f"{tag}: the sync daemon is already down "
                            "(overlapping outages need a SyncRestore between)")
            sync_outage_open = True
        elif kind == "sync-restore":
            if not sync_outage_open:
                errs.append(f"{tag}: SyncRestore with no open SyncOutage "
                            "before it")
            sync_outage_open = False
        elif kind == "sync-bias":
            for sel in (ev.src, ev.dst):
                if sel != "all":
                    try:
                        _clock_targets(sel, n, n_prox)
                    except ValueError as exc:
                        errs.append(f"{tag}: {exc}")
            if not np.isfinite(ev.bias):
                errs.append(f"{tag}: bias must be finite")
        elif kind == "clock-leap":
            try:
                _clock_targets(ev.who, n, n_prox)
            except ValueError as exc:
                errs.append(f"{tag}: {exc}")
            if not (np.isfinite(ev.delta) and ev.delta != 0.0):
                errs.append(f"{tag}: delta must be finite and nonzero")
        elif kind == "net-shift" and ev.profile not in NET_PROFILES:
            errs.append(f"{tag}: unknown net profile {ev.profile!r}; "
                        "available: " + ", ".join(NET_PROFILES))
    if errs:
        raise ValueError(
            f"invalid scenario {sc.name!r}: " + "; ".join(errs))


# The one result schema every (protocol x backend x tier x scenario) run
# returns (the reference's schema, key for key).
SCENARIO_RESULT_KEYS = (
    "protocol", "backend", "tier", "scenario", "n_requests", "committed",
    "fast_commit_ratio", "median_latency", "p90_latency", "mean_latency",
    "throughput", "epochs", "view_changes", "recovered_entries",
    "dropped_speculative", "applied_faults", "skipped_faults",
    "partition_epochs", "gray_link_epochs", "invariant_violations",
    "groups", "per_group_view_changes", "cross_group_ops",
    "cross_group_violations",
)


@dataclass
class ScenarioResult:
    """Uniform scenario-run summary. ``tier`` is the compute tier
    (``torch-cuda`` or ``torch-cpu``; ``"event"`` for a discrete-event
    backend, none of which is ported); ``raw`` keeps
    the backend's full `summary()` dict for backend-specific extras.

    ``applied_faults`` counts events the backend ACCEPTED AND SCHEDULED,
    ``skipped_faults`` those it cannot model. Acceptance does not imply
    firing: an event stamped past the run horizon is counted applied but
    never executes -- cataloged scenarios always place fault times inside
    the horizon (enforced by `_validate_scenario`).

    ``view_changes`` is the highest view entered by the recovery pipeline;
    ``recovered_entries``/``dropped_speculative`` count what the view
    changes' MERGE-LOG kept/discarded beyond the synced prefix (0 on
    backends without a recovery pipeline).

    Fault-exposure counters: ``partition_epochs``/``gray_link_epochs``
    count the epochs the run spent under an active partition/gray fault.
    ``invariant_violations`` is the number of findings the paired
    adversarial trace checkers raised (filled by
    `repro_torch.sim.trace.run_scenario_with_trace`; 0 when the run was
    summarized without trace capture)."""

    protocol: str
    backend: str
    tier: str
    scenario: str
    n_requests: int
    committed: int
    fast_commit_ratio: float
    median_latency: float
    p90_latency: float
    mean_latency: float
    throughput: float
    epochs: int
    view_changes: int
    recovered_entries: int
    dropped_speculative: int
    applied_faults: int
    skipped_faults: int
    partition_epochs: int = 0
    gray_link_epochs: int = 0
    invariant_violations: int = 0
    # Sharded-backend extras (single-group backends report the identity:
    # one group, its own view-change count, no cross-group ops).
    # ``cross_group_violations`` counts findings of the cross-group
    # linearizability checker specifically (subset of
    # ``invariant_violations``; filled by `run_scenario_with_trace`).
    groups: int = 1
    per_group_view_changes: list = field(default_factory=list)
    cross_group_ops: int = 0
    cross_group_violations: int = 0
    raw: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.groups < 1:
            raise ValueError(f"groups={self.groups}: needs >= 1")
        if not self.per_group_view_changes:
            self.per_group_view_changes = [int(self.view_changes)] \
                if self.groups == 1 else [0] * self.groups
        if len(self.per_group_view_changes) != self.groups:
            raise ValueError(
                f"per_group_view_changes has {len(self.per_group_view_changes)}"
                f" entries for {self.groups} group(s)")
        if self.cross_group_ops < 0 or self.cross_group_violations < 0:
            raise ValueError("cross-group counters must be >= 0")

    @classmethod
    def from_summary(cls, scenario: Scenario, summary: dict,
                     applied_faults: int, skipped_faults: int) -> "ScenarioResult":
        return cls(
            protocol=summary["protocol"],
            backend=summary["backend"],
            tier=summary.get("tier", "event"),
            scenario=scenario.name,
            n_requests=int(summary["n_requests"]),
            committed=int(summary["committed"]),
            fast_commit_ratio=float(summary["fast_commit_ratio"]),
            median_latency=float(summary["median_latency"]),
            p90_latency=float(summary["p90_latency"]),
            mean_latency=float(summary["mean_latency"]),
            throughput=float(summary.get("throughput", float("nan"))),
            epochs=int(summary.get("epochs", 0)),
            view_changes=int(summary.get("view_changes", 0)),
            recovered_entries=int(summary.get("recovered_entries", 0)),
            dropped_speculative=int(summary.get("dropped_speculative", 0)),
            applied_faults=applied_faults,
            skipped_faults=skipped_faults,
            partition_epochs=int(summary.get("partition_epochs", 0)),
            gray_link_epochs=int(summary.get("gray_link_epochs", 0)),
            invariant_violations=int(summary.get("invariant_violations", 0)),
            groups=int(summary.get("groups", 1)),
            per_group_view_changes=[
                int(v) for v in summary.get("per_group_view_changes", [])],
            cross_group_ops=int(summary.get("cross_group_ops", 0)),
            cross_group_violations=int(
                summary.get("cross_group_violations", 0)),
            raw=dict(summary),
        )

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in SCENARIO_RESULT_KEYS}


# ---------------------------------------------------------------------------
# Scenario catalog
# ---------------------------------------------------------------------------
# The clock-fault family shares one workload so Appendix D's latency ordering
# (faulty > baseline; capped < uncapped) is an apples-to-apples comparison
# against the "intra-zone" baseline scenario.
_STD_WORKLOAD = Workload(mode="open", rate_per_client=2000.0, duration=0.15,
                         warmup=0.02, drain=0.1, seed=0)
_CLOCK_MU = 300e-6          # Appendix D: |offset| = 300us, sigma = 30us
_CLOCK_SIGMA = 30e-6
_CAP = 50e-6                # SD.2.4 deadline cap
# The adversarial family reuses the crash family's write-only uniform
# traffic (fault windows must see steady commit flow).
_ADV_WORKLOAD = Workload(mode="open", rate_per_client=2000.0, duration=0.15,
                         warmup=0.02, drain=0.1, seed=0,
                         read_ratio=0.0, skew=0.0)
# The sync family runs longer: the degradation detector compares the worst
# reported bound against a healthy-percentile baseline, so the run needs
# enough clean probe rounds on BOTH sides of the fault window.
_SYNC_WORKLOAD = Workload(mode="open", rate_per_client=2000.0, duration=0.3,
                          warmup=0.02, drain=0.1, seed=0,
                          read_ratio=0.0, skew=0.0)


def _clock_scenario(name: str, who: str, mu: float, cap: float = 0.0,
                    description: str = "") -> Scenario:
    over: dict[str, Any] = {"n_proxies": 2}
    if cap > 0.0:
        over["deadline_cap"] = cap
    return Scenario(
        name, environment="gcp-intra-zone",
        faults=(ClockFault(0.0, who=who, mu=mu, sigma=_CLOCK_SIGMA),),
        workload=_STD_WORKLOAD, overrides=over, description=description)


SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (
        Scenario("intra-zone", workload=_STD_WORKLOAD,
                 overrides={"n_proxies": 2},
                 description="baseline: intra-zone fabric, open loop "
                             "(also Appendix D's no-fault reference)"),
        Scenario("intra-zone-closed",
                 workload=Workload(mode="closed", duration=0.15, drain=0.1),
                 description="baseline: closed loop, one lane per client"),
        Scenario("multi-zone", environment="multi-zone",
                 workload=Workload(mode="open", rate_per_client=1000.0,
                                   duration=0.2, warmup=0.02, drain=0.15),
                 description="multi-zone placement: 6x delays + path spread"),
        Scenario("wan", environment="wan",
                 workload=Workload(mode="open", rate_per_client=200.0,
                                   duration=1.5, warmup=0.1, drain=0.5),
                 overrides={"n_proxies": 2},
                 description="Fig 13: cross-region WAN, proxies with clients"),
        Scenario("lossy", environment="lossy", workload=_STD_WORKLOAD,
                 description="1% loss: retries + quorum slack do the work"),
        Scenario("congested", environment="congested",
                 workload=Workload(mode="open", rate_per_client=1000.0,
                                   duration=0.15, warmup=0.02, drain=0.1),
                 description="bursty congested fabric (S3's reordering regime)"),
        # The crash family declares the paper's Fig 14/15 workload verbatim:
        # uniform write-only traffic (read_ratio/skew 0).
        Scenario("leader-crash",
                 faults=(Crash(0.15, rid=0),),
                 workload=Workload(mode="open", rate_per_client=2000.0,
                                   duration=0.4, warmup=0.02, drain=0.2,
                                   read_ratio=0.0, skew=0.0),
                 overrides={"n_proxies": 2},
                 description="Fig 14: leader dies mid-run; view change + "
                             "slow-path continuation"),
        Scenario("crash-recovery",
                 faults=(Crash(0.15, rid=0), Relaunch(0.3, rid=0)),
                 workload=Workload(mode="open", rate_per_client=2000.0,
                                   duration=0.5, warmup=0.02, drain=0.2,
                                   read_ratio=0.0, skew=0.0),
                 overrides={"n_proxies": 2},
                 description="Fig 15: crash, then the replica rejoins"),
        # Recovery edge cases (paper SA): cascading leader failure, a
        # relaunch racing the merge, and a total outage. Timed against the
        # vectorized pipeline's detection window (heartbeat_timeout 25ms):
        # the second event lands while the first view change is in flight.
        Scenario("leader-crash-cascade", f=2,
                 faults=(Crash(0.12, rid=0), Crash(0.13, rid=1)),
                 workload=Workload(mode="open", rate_per_client=1500.0,
                                   duration=0.3, warmup=0.02, drain=0.2,
                                   read_ratio=0.0, skew=0.0),
                 overrides={"n_proxies": 2},
                 description="SA edge: the NEW leader dies during recovery; "
                             "the view change escalates past it (f=2)"),
        Scenario("relaunch-mid-recovery",
                 faults=(Crash(0.12, rid=0), Relaunch(0.13, rid=0)),
                 workload=Workload(mode="open", rate_per_client=1500.0,
                                   duration=0.3, warmup=0.02, drain=0.2,
                                   read_ratio=0.0, skew=0.0),
                 overrides={"n_proxies": 2},
                 description="SA edge: the old leader relaunches before the "
                             "merge completes; leadership stays view-based"),
        Scenario("total-outage",
                 faults=(Crash(0.12, rid=0), Crash(0.12, rid=1),
                         Crash(0.12, rid=2),
                         Relaunch(0.25, rid=0), Relaunch(0.25, rid=1)),
                 workload=Workload(mode="open", rate_per_client=1500.0,
                                   duration=0.4, warmup=0.02, drain=0.2,
                                   read_ratio=0.0, skew=0.0),
                 overrides={"n_proxies": 2},
                 description="SA edge: every replica down, then a quorum "
                             "relaunches (beyond-f outage; diskless recovery "
                             "cannot resume on the event backend)"),
        _clock_scenario("clock-skew-leader", "leader", -_CLOCK_MU,
                        description="Appendix D: leader clock 300us slow"),
        _clock_scenario("clock-skew-leader-capped", "leader", -_CLOCK_MU,
                        cap=_CAP,
                        description="Appendix D: slow leader + deadline cap"),
        _clock_scenario("clock-skew-follower", "replica:1", _CLOCK_MU,
                        description="Appendix D: one follower 300us fast"),
        _clock_scenario("clock-skew-proxy", "proxies", _CLOCK_MU,
                        description="Appendix D: proxy clocks 300us fast"),
        _clock_scenario("clock-skew-proxy-capped", "proxies", _CLOCK_MU,
                        cap=_CAP,
                        description="Appendix D: fast proxies + deadline cap"),
        # ------------------------------------------------------------------
        # Adversarial network family: partitions, gray failures and
        # Byzantine-leaning faults. Each scenario names the trace invariant
        # that must fire on the faulty run and stay silent on `control()`.
        # All share the crash family's write-only uniform workload.
        # ------------------------------------------------------------------
        Scenario("leader-minority-partition",
                 faults=(Partition(0.05, groups=((0,), (1, 2))),
                         Heal(0.16)),
                 workload=_ADV_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="partition-liveness",
                 description="the view-0 leader lands alone on the minority "
                             "side; the majority view-changes and keeps "
                             "committing, the minority provably does not"),
        Scenario("split-brain-attempt",
                 faults=(LossyAcker(0.03, rid=1),
                         Partition(0.05, groups=((0,), (1, 2))),
                         Crash(0.095, rid=1),   # after the majority's view
                         #   change elects the lossy acker leader of view 1
                         Heal(0.10),
                         Relaunch(0.13, rid=1)),
                 workload=_ADV_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="split-brain",
                 description="a lossy acker becomes leader behind a "
                             "partition, crashes, and relaunches trusting "
                             "its truncated durable log: two durable "
                             "histories now hold conflicting entries"),
        Scenario("flapping-links",
                 faults=(GrayLink(0.04, "*", "*", drop_prob=0.35),
                         GrayClear(0.06),
                         GrayLink(0.08, "*", "*", drop_prob=0.35),
                         GrayClear(0.10)),
                 workload=_ADV_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="partition-liveness",
                 description="proxy<->replica links flap between healthy "
                             "and 35% loss; commit health collapses inside "
                             "each gray window and recovers between them"),
        Scenario("slow-but-alive-replica",
                 faults=(GrayLink(0.04, "*", "replica:2",
                                  delay_mu=2e-3, delay_sigma=100e-6),
                         GrayClear(0.11, "*", "replica:2")),
                 workload=_ADV_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="partition-liveness",
                 description="every link to replica 2 gains ~2ms: the "
                             "replica never fails, but the fast path "
                             "(which needs all 2f+1 replies) dies"),
        Scenario("skewed-proxy",
                 faults=(SkewedStamper(0.04, proxy_id=1, bias=400e-6),),
                 workload=_ADV_WORKLOAD, overrides={"n_proxies": 3},
                 invariant="stamp-bias",
                 description="proxy 1 stamps deadlines 400us late; the "
                             "per-proxy deadline-offset estimator flags it "
                             "far beyond clock-sync error"),
        # ------------------------------------------------------------------
        # Sharded family (nezha-sharded): multi-group key-space sharding.
        # Both reuse the standard rate and G=4 groups; the multi-key
        # scenario's invariant is the cross-group linearizability checker.
        # ------------------------------------------------------------------
        Scenario("sharded-multi-key", groups=4,
                 workload=Workload(mode="open", rate_per_client=2000.0,
                                   duration=0.15, warmup=0.02, drain=0.1,
                                   seed=0, multiop_ratio=0.15,
                                   multiop_span=3),
                 invariant="cross-group",
                 description="G=4 groups over one key space; 15% of ops "
                             "span several groups and must commit "
                             "atomically in global deadline order with no "
                             "cross-group coordination round"),
        Scenario("sharded-group-crash", groups=4,
                 faults=(GroupFault(1, Crash(0.08, rid=0)),),
                 workload=Workload(mode="open", rate_per_client=2000.0,
                                   duration=0.25, warmup=0.02, drain=0.15,
                                   seed=0, read_ratio=0.0, skew=0.0),
                 description="group 1's leader dies mid-run: that group "
                             "view-changes and recovers while the other "
                             "three keep committing undisturbed"),
        Scenario("ack-without-persist",
                 faults=(LossyAcker(0.03, rid=2),
                         Crash(0.09, rid=2),
                         Relaunch(0.13, rid=2)),
                 workload=_ADV_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="durability",
                 description="replica 2 acks without persisting; its crash "
                             "+ relaunch exposes the acked-but-missing "
                             "prefix"),
        # ------------------------------------------------------------------
        # Modeled clock-sync family: the drifty regime runs the
        # measured sync loop, so these degrade the MEASUREMENT process and
        # the trace checks verify the reported error bounds stayed honest
        # (coverage) while the paired invariant detects the degradation.
        # ------------------------------------------------------------------
        Scenario("sync-daemon-outage", environment="drifty-clocks",
                 faults=(SyncOutage(0.05), SyncRestore(0.25)),
                 workload=_SYNC_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="sync-degraded",
                 description="the sync daemon dies for 200ms: clocks drift "
                             "unobserved, the reported bound grows at the "
                             "3-sigma drift rate (DOM's margin widens with "
                             "it), then recovery narrows it back"),
        Scenario("sync-path-bias", environment="drifty-clocks",
                 faults=(SyncBias(0.05, src="all", dst="replica:1",
                                  bias=140e-6),
                         SyncBias(0.05, src="all", dst="replica:2",
                                  bias=140e-6),
                         SyncBias(0.25, src="all", dst="replica:1", bias=0.0),
                         SyncBias(0.25, src="all", dst="replica:2",
                                  bias=0.0)),
                 workload=_SYNC_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="sync-degraded",
                 description="probes toward two replicas read 140us of "
                             "path asymmetry: the median estimate shifts, "
                             "the MAD-based bound inflates to cover it, "
                             "and coverage holds because the bound is "
                             "measured, not asserted"),
        Scenario("clock-leap", environment="drifty-clocks",
                 faults=(ClockLeap(0.05, who="leader", delta=300e-6),),
                 workload=_SYNC_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="sync-step",
                 description="the leader's clock steps 300us (VM "
                             "migration): the next probe round flags the "
                             "correction as a step event and inflates the "
                             "bound to the full step until re-measured"),
        Scenario("sync-degrade-recover", environment="drifty-clocks",
                 faults=(SyncOutage(0.06), SyncRestore(0.20)),
                 workload=_SYNC_WORKLOAD, overrides={"n_proxies": 2},
                 invariant="sync-degraded",
                 description="a shorter outage: the bound degrades then "
                             "provably recovers (end-of-run sigma back "
                             "under the outage peak)"),
    )
}

# The adversarial family, in catalog order (tests iterate this).
ADVERSARIAL_SCENARIOS = (
    "leader-minority-partition", "split-brain-attempt", "flapping-links",
    "slow-but-alive-replica", "skewed-proxy", "ack-without-persist",
)

# The sharded family, in catalog order.
SHARDED_SCENARIOS = ("sharded-multi-key", "sharded-group-crash")

# The modeled clock-sync family, in catalog order. All run the drifty
# regime's measured sync loop.
SYNC_SCENARIOS = ("sync-daemon-outage", "sync-path-bias", "clock-leap",
                  "sync-degrade-recover")


def available_scenarios() -> tuple[str, ...]:
    return tuple(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {', '.join(SCENARIOS)}") from None


def resolve_scenario(scenario: Union[str, Scenario]) -> Scenario:
    return get_scenario(scenario) if isinstance(scenario, str) else scenario


# ---------------------------------------------------------------------------
# Scenario -> config construction
# ---------------------------------------------------------------------------
def _apply_override(cfg, key: str, value) -> bool:
    """Apply one override to ``cfg`` (a config dataclass instance).

    Resolution order: a directly-declared field; else the same-named field on
    the nested ``replica`` params; else on the nested ``dom`` params. A
    ``dom`` override given as a plain dict is merged into the target's own
    `DomParams` (`dataclasses.replace`). Returns False when the config
    family declares no such knob (cross-family overrides must not leak,
    mirroring the registry's config promotion rule).
    """
    names = {f.name for f in dataclasses.fields(cfg)}
    if key in names:
        if key == "dom" and isinstance(value, dict):
            value = replace(getattr(cfg, "dom"), **value)
        setattr(cfg, key, value)
        return True
    for nested in ("replica", "dom"):
        if nested not in names:
            continue
        obj = getattr(cfg, nested)
        if obj is not None and dataclasses.is_dataclass(obj) and \
                key in {f.name for f in dataclasses.fields(obj)}:
            setattr(obj, key, value)
            return True
    return False


def build_config(protocol_name: str, scenario: Union[str, Scenario]):
    """The Scenario-driven construction path for `make_cluster`.

    Builds ``protocol_name``'s own config class from the scenario: the shared
    `CommonConfig` core (f, clients, seed) plus the environment's fabric and
    clock regime, then the environment + scenario overrides -- each applied
    only where the config family declares the knob.
    """
    from repro_torch.core.registry import config_class

    sc = resolve_scenario(scenario)
    env = sc.env
    cls = config_class(protocol_name)
    cfg = cls(f=sc.f, n_clients=sc.n_clients, seed=sc.seed,
              net=env.net, clock=env.clock)
    if sc.groups != 1:
        # Only sharding-capable config families declare the knob; on any
        # other backend a multi-group scenario runs its single-group
        # projection (the workload and faults still apply).
        _apply_override(cfg, "groups", sc.groups)
    merged = {**env.overrides, **sc.overrides}
    # `dom` first: later flat overrides (e.g. a scenario's deadline_cap) may
    # target the replica/dom params the dom override just installed.
    for key in sorted(merged, key=lambda k: k != "dom"):
        _apply_override(cfg, key, merged[key])
    if "dom" in merged and "replica" in {f.name for f in dataclasses.fields(cfg)} \
            and getattr(cfg, "replica", None) is not None:
        # Keep the replica-side DOM params in lockstep with the sender side.
        cfg.replica.dom = cfg.dom
    return cfg


def make_scenario_cluster(protocol_name: str, scenario: Union[str, Scenario],
                          *, device: Optional[str] = None, config=None, **kw):
    """Build ``protocol_name`` configured for ``scenario`` with the fault
    schedule applied. Returns ``(cluster, scenario, skipped_faults)`` --
    callers that need custom probing drive the cluster themselves;
    `run_scenario` is the one-call path.

    ``device`` ("cuda" or "cpu") pins where the engine runs; None keeps the
    config's own (`VectorizedConfig.device`: the card)."""
    from repro_torch.core.registry import make_cluster

    sc = resolve_scenario(scenario)
    cfg = config if config is not None else build_config(protocol_name, sc)
    if device is not None and cfg.device != device:
        cfg = replace(cfg, device=device)
    cluster = make_cluster(protocol_name, cfg, **kw)
    skipped = []
    for ev in sorted(sc.faults, key=lambda e: e.t):
        if not cluster.schedule_fault(ev):
            skipped.append(ev)
    return cluster, sc, skipped


def run_scenario_on_cluster(protocol_name: str,
                            scenario: Union[str, Scenario], *,
                            device: Optional[str] = None, config=None,
                            **kw):
    """`run_scenario`, additionally returning the driven cluster -- for
    callers that inspect post-run state (`repro_torch.sim.trace` records
    the commit trace from it). Returns ``(result, cluster)``."""
    cluster, sc, skipped = make_scenario_cluster(
        protocol_name, scenario, device=device, config=config, **kw)
    summary = WorkloadDriver(sc.workload).run(cluster)
    n_faults = len(sc.faults)
    result = ScenarioResult.from_summary(
        sc, summary, applied_faults=n_faults - len(skipped),
        skipped_faults=len(skipped))
    return result, cluster


def run_scenario(protocol_name: str, scenario: Union[str, Scenario], *,
                 device: Optional[str] = None, config=None,
                 **kw) -> ScenarioResult:
    """Run one scenario on one backend, on the card unless ``device="cpu"``.

    ``config`` overrides the scenario-built config entirely (escape hatch);
    extra keywords go to the cluster constructor. Fault events the backend
    cannot model are skipped and counted in the result rather than raising.
    """
    return run_scenario_on_cluster(protocol_name, scenario, device=device,
                                   config=config, **kw)[0]


__all__ = [
    "NET_PROFILES", "CLOCK_REGIMES", "ENVIRONMENTS", "Environment",
    "FaultEvent", "Crash", "Relaunch", "ClockFault", "ClockClear", "NetShift",
    "Partition", "Heal", "GrayLink", "GrayClear", "SkewedStamper",
    "LossyAcker", "SyncOutage", "SyncRestore", "SyncBias", "ClockLeap",
    "GroupFault", "NET_FAULT_KINDS",
    "Scenario", "ScenarioResult", "SCENARIO_RESULT_KEYS",
    "SCENARIOS", "ADVERSARIAL_SCENARIOS", "SHARDED_SCENARIOS",
    "SYNC_SCENARIOS",
    "available_scenarios", "get_scenario", "resolve_scenario",
    "build_config", "make_scenario_cluster", "run_scenario",
    "run_scenario_on_cluster",
]
