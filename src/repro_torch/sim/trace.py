"""Port of `repro/sim/trace.py`: commit-trace recording and the invariant
checkers over it.

The recovery pipeline (paper SA) is only trustworthy if its *observable*
guarantees hold under every fault schedule, on the card as on the CPU.
This module gives each run one common currency -- a `CommitTrace`:

  log       the durable (synced) log in execution order: one row per entry
            with its deadline, uid = (client-id, request-id), commutativity
            class, the view/batch that committed it, and whether the
            recovery MERGE-LOG (rather than normal operation) admitted it;
  commits   the client-observed deliveries: commit time, uid, fast/slow,
            recovered.

and one checker vocabulary over it:

  check_at_most_once        no uid executes twice (dup-free log AND dup-free
                            client deliveries -- retries must be replays);
  check_durable_log         durable-prefix preservation across views: every
                            client-delivered commit is present in the final
                            durable log, i.e. no MERGE-LOG ever dropped a
                            committed entry;
  check_deadline_order      within-view ordering: execution order is
                            deadline order per commutativity class (S8.2) --
                            scoped to the whole log on an event backend and
                            to each epoch batch on the vectorized one (the
                            documented windowed approximation);
  check_equivalent_commits  cross-run commit-sequence equivalence: two runs
                            of the same scenario committed exactly the same
                            request set.

The adversarial fault family adds detection invariants, each paired with
the scenario that must trip it (`ADVERSARIAL_CHECKS` maps the scenario's
``invariant`` name to its checker):

  check_split_brain         two durable logs hold conflicting entries at the
                            same position (honest Nezha logs are always
                            prefix-consistent);
  check_stamp_bias          the per-proxy deadline-offset estimator flags a
                            proxy whose median offset deviates from the
                            cross-proxy median beyond clock-sync error;
  check_durability          a crashed replica acked entries it never
                            persisted (LossyAcker exposed on relaunch);
  check_partition_liveness  fault-window liveness: during a partition the
                            majority commits while the minority provably
                            does not (or nobody commits at all); during a
                            gray window commit rate or fast-path health
                            collapses relative to clean operation;
  check_sync_degraded       the modeled sync daemon's reported error bound
  check_sync_step           widened past its healthy level / it flagged a
                            clock step.

A sharded run is recorded as a `ShardedTrace` -- one `CommitTrace` per
consensus group plus the multi-op ground truth (which groups must hold
each cross-group op, at which pre-stamped global deadline) -- checked by:

  check_cross_group_linearizability
                            cross-group atomicity + global deadline order
                            for multi-key ops: no torn op (durable in some
                            involved groups but not all), bit-equal logged
                            deadline across groups (the one pre-stamped
                            value), and consistent relative order agreeing
                            with global deadline order wherever two
                            multi-ops share >= 2 groups.

The checkers are plain numpy over trace data. `CommitTrace.from_cluster`
dispatches on the backend: ``nezha-vectorized``
(`CommitTrace.from_vectorized_cluster`), ``nezha-sharded``
(`ShardedTrace.from_sharded_cluster`) and the event-driven Nezha backends
(`CommitTrace.from_event_cluster`: ``nezha``, ``nezha-nonproxy``).
`run_scenario_with_trace` is the one-call form; like `run_scenario` it runs
the vectorized backends on the card unless passed ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.recovery import pack_uids as _pack

COMMIT_COLS = ("t", "cid", "rid", "fast", "recovered")
LOG_COLS = ("deadline", "cid", "rid", "kcls", "view", "batch", "recovered")

_LOG_DTYPES = dict(deadline=np.float64, cid=np.int64, rid=np.int64,
                   kcls=np.int64, view=np.int64, batch=np.int64,
                   recovered=bool)
_COMMIT_DTYPES = dict(t=np.float64, cid=np.int64, rid=np.int64,
                      fast=bool, recovered=bool)


@dataclass
class CommitTrace:
    """One run's committed history: durable log + client deliveries."""

    protocol: str
    backend: str
    tier: str
    log: dict = field(default_factory=dict)       # LOG_COLS -> np.ndarray
    commits: dict = field(default_factory=dict)   # COMMIT_COLS -> np.ndarray
    # Ordering scope of the deadline-order invariant: "log" = the whole
    # durable log is per-class deadline-ordered (event backend); "batch" =
    # ordered within each epoch batch (the vectorized engine's windowed
    # steady-state approximation).
    order_scope: str = "log"
    # Adversarial-family evidence; empty when the run recorded none.
    stamps: dict = field(default_factory=dict)    # {"pid","doff"} per request:
    #   issuing proxy id and deadline minus honest local send time
    durability: list = field(default_factory=list)  # crash-time durability
    #   holes: {"replica","acked","persisted","missing","uids"}
    replica_logs: dict = field(default_factory=dict)  # rid -> {"cid","rid"}
    #   per-replica durable-log views (positional; split-brain evidence)
    net_windows: list = field(default_factory=list)   # partition/gray fault
    #   windows: {"kind","t0","t1"[,"minority","minority_progress"]}
    # Clock-sync evidence: per-round per-node estimator audit rows
    # {"t","node","err","sigma","events"} -- pre-correction true offset error
    # vs the error bound the daemon *reported* for that round. Empty when the
    # run used injected offsets (no modeled sync loop).
    sync: dict = field(default_factory=dict)

    def __post_init__(self):
        for col in LOG_COLS:
            self.log.setdefault(col, np.empty(0, _LOG_DTYPES[col]))
        for col in COMMIT_COLS:
            self.commits.setdefault(col, np.empty(0, _COMMIT_DTYPES[col]))
        self.stamps.setdefault("pid", np.empty(0, np.int64))
        self.stamps.setdefault("doff", np.empty(0, np.float64))

    @property
    def log_uids(self) -> np.ndarray:
        return _pack(self.log["cid"], self.log["rid"])

    @property
    def commit_uids(self) -> np.ndarray:
        return _pack(self.commits["cid"], self.commits["rid"])

    @property
    def label(self) -> str:
        return f"{self.protocol}/{self.backend}/{self.tier}"

    # -- builders -------------------------------------------------------------
    @classmethod
    def from_cluster(cls, cluster):
        if cluster.backend == "vectorized":
            return cls.from_vectorized_cluster(cluster)
        if cluster.backend == "sharded":
            return ShardedTrace.from_sharded_cluster(cluster)
        if cluster.backend == "event":
            return cls.from_event_cluster(cluster)
        raise NotImplementedError(
            f"no trace builder for the {cluster.backend!r} backend")

    @classmethod
    def from_vectorized_cluster(cls, cluster) -> "CommitTrace":
        log = cluster.engine.logs.log_columns()
        recs = cluster._trace_commits
        commits = {
            col: (np.concatenate([np.asarray(r[i]) for r in recs])
                  if recs else np.empty(0, _COMMIT_DTYPES[col]))
            for i, col in enumerate(COMMIT_COLS)
        }
        tr = cls(protocol=cluster.protocol, backend="vectorized",
                 tier=cluster.engine.tier_name, log=log, commits=commits,
                 order_scope="batch")
        st = getattr(cluster, "_trace_stamps", None)
        if st:
            tr.stamps = {
                "pid": np.concatenate([np.asarray(p, np.int64) for p, _ in st]),
                "doff": np.concatenate([np.asarray(d, np.float64) for _, d in st]),
            }
        logs = cluster.engine.logs
        tr.durability = list(getattr(logs, "durability_events", ()))
        if getattr(logs, "has_holes", False):
            tr.replica_logs = {
                r: {"cid": cols["cid"], "rid": cols["rid"]}
                for r, cols in logs.replica_log_columns().items()}
        if hasattr(cluster, "net_windows"):
            tr.net_windows = cluster.net_windows()
        cs = getattr(cluster.engine, "clocksync", None)
        if cs is not None:
            tr.sync = cs.evidence_columns()
        return tr

    @classmethod
    def from_event_cluster(cls, cluster) -> "CommitTrace":
        # client-observed deliveries
        t, cid, rid, fast = [], [], [], []
        for c in cluster.clients:
            for req_id, rec in c.records.items():
                if np.isfinite(rec.commit_time):
                    t.append(rec.commit_time)
                    cid.append(c.id)
                    rid.append(req_id)
                    fast.append(rec.fast_path)
        commits = {"t": np.asarray(t, np.float64),
                   "cid": np.asarray(cid, np.int64),
                   "rid": np.asarray(rid, np.int64),
                   "fast": np.asarray(fast, bool),
                   "recovered": np.zeros(len(t), bool)}
        # durable log: the most advanced live NORMAL replica (the leader in
        # steady state); during an outage, the most advanced replica at all
        ref = max(cluster.replicas,
                  key=lambda r: (r.alive, r.view_id, len(r.synced)))
        kcls_intern: dict = {}
        deadline, lcid, lrid, kcls = [], [], [], []
        for e in ref.synced:
            keys = tuple(e.request.keys) if e.request is not None else ()
            if not keys:
                k = -1
            else:
                k = kcls_intern.setdefault(keys, len(kcls_intern))
            deadline.append(e.deadline)
            lcid.append(e.client_id)
            lrid.append(e.request_id)
            kcls.append(k)
        n = len(deadline)
        log = {"deadline": np.asarray(deadline, np.float64),
               "cid": np.asarray(lcid, np.int64),
               "rid": np.asarray(lrid, np.int64),
               "kcls": np.asarray(kcls, np.int64),
               "view": np.zeros(n, np.int64),
               "batch": np.zeros(n, np.int64),
               "recovered": np.zeros(n, bool)}
        tr = cls(protocol=cluster.protocol, backend="event", tier="event",
                 log=log, commits=commits, order_scope="log")
        audit = getattr(cluster, "_stamp_audit", None)
        if audit:
            tr.stamps = {
                "pid": np.asarray([p for p, _ in audit], np.int64),
                "doff": np.asarray([d for _, d in audit], np.float64)}
        tr.durability = list(getattr(cluster, "_durability_events", ()))
        # Split-brain evidence compares only logs that claim authority NOW:
        # honest replicas in the highest view, plus divergent ones (which
        # claim NORMAL in a stale view they refuse to leave). A lagging
        # replica mid-catch-up is excluded -- its stale pre-MERGE-LOG tail
        # legitimately differs positionally (the view change re-sorts the
        # speculative suffix by deadline) and the protocol is repairing it.
        reps = [r for r in getattr(cluster, "replicas", ()) if r.alive]
        honest = [r for r in reps if not getattr(r, "divergent", False)]
        vmax = max((r.view_id for r in honest), default=0)
        tr.replica_logs = {
            r.id: {"cid": np.asarray([e.client_id for e in r.synced], np.int64),
                   "rid": np.asarray([e.request_id for e in r.synced], np.int64)}
            for r in reps
            if getattr(r, "divergent", False) or r.view_id == vmax}
        if hasattr(cluster, "net_windows"):
            tr.net_windows = cluster.net_windows()
        sync = getattr(cluster, "sync", None)
        if sync is not None and getattr(sync, "_modeled", False):
            tr.sync = sync.evidence_columns()
        return tr


@dataclass
class ShardedTrace:
    """A sharded run's history: one `CommitTrace` per consensus group plus
    the multi-op ground truth. Per-group invariants run on each group trace
    unchanged; `check_cross_group_linearizability` consumes the whole."""

    protocol: str
    backend: str
    tier: str
    groups: list = field(default_factory=list)    # per-group CommitTrace
    # packed uid -> {"groups": tuple, "deadline": float} for every op that
    # spanned >= 2 groups (copied from the cluster's routing decisions)
    multiops: dict = field(default_factory=dict)

    @property
    def label(self) -> str:
        return f"{self.protocol}/{self.backend}/{self.tier}"

    @property
    def commit_uids(self) -> np.ndarray:
        """Client-observed committed uids across all groups (a multi-op
        counts once iff EVERY involved group delivered it)."""
        if not self.groups:
            return np.empty(0, np.int64)
        u = np.concatenate([g.commit_uids for g in self.groups])
        uniq, counts = np.unique(u, return_counts=True)
        expected = np.asarray(
            [len(self.multiops[int(x)]["groups"]) if int(x) in self.multiops
             else 1 for x in uniq])
        return uniq[counts >= expected]

    @classmethod
    def from_sharded_cluster(cls, cluster) -> "ShardedTrace":
        return cls(
            protocol=cluster.protocol, backend=cluster.backend,
            tier=cluster.groups[0].engine.tier_name,
            groups=[CommitTrace.from_vectorized_cluster(g)
                    for g in cluster.groups],
            multiops={int(u): {"groups": tuple(info["groups"]),
                               "deadline": float(info["deadline"])}
                      for u, info in cluster._multi.items()})


# ---------------------------------------------------------------------------
# invariant checks (each returns a list of violation strings; empty = OK)
# ---------------------------------------------------------------------------
def _dups(uids: np.ndarray) -> np.ndarray:
    uniq, counts = np.unique(uids, return_counts=True)
    return uniq[counts > 1]


def _uid_str(packed: np.ndarray, limit: int = 5) -> str:
    items = [f"({u >> 32}, {u & 0xFFFFFFFF})" for u in packed[:limit].tolist()]
    more = "" if packed.size <= limit else f" (+{packed.size - limit} more)"
    return ", ".join(items) + more


def check_at_most_once(trace: CommitTrace) -> list[str]:
    """No request executes twice: the durable log holds each uid at most
    once, and each uid is delivered to its client at most once (a retried
    request's duplicate attempts must be answered by replay)."""
    out = []
    d = _dups(trace.log_uids)
    if d.size:
        out.append(f"{trace.label}: log holds duplicated uids {_uid_str(d)}")
    d = _dups(trace.commit_uids)
    if d.size:
        out.append(f"{trace.label}: clients saw duplicate commits for uids "
                   f"{_uid_str(d)}")
    return out


def check_durable_log(trace: CommitTrace) -> list[str]:
    """Durable-prefix preservation across views: every client-delivered
    commit is in the final durable log -- no view change (MERGE-LOG) ever
    dropped a committed entry."""
    missing = np.setdiff1d(trace.commit_uids, trace.log_uids)
    if missing.size:
        return [f"{trace.label}: committed uids missing from the durable "
                f"log after {int(trace.log['view'].max(initial=0))} view(s): "
                f"{_uid_str(missing)}"]
    return []


def check_deadline_order(trace: CommitTrace) -> list[str]:
    """Within-view ordering: execution (log) order is deadline order per
    commutativity class (S8.2), scoped per `trace.order_scope`."""
    log = trace.log
    n = log["deadline"].size
    if n == 0:
        return []
    if trace.order_scope == "batch":
        group = _pack(log["batch"], log["kcls"] + 1)  # kcls may be -1
    else:
        group = log["kcls"]
    out = []
    order = np.argsort(group, kind="stable")    # stable: log order per group
    g = group[order]
    d = log["deadline"][order]
    same_group = g[1:] == g[:-1]
    bad = same_group & (d[1:] < d[:-1])
    if bad.any():
        idx = order[1:][bad]
        out.append(
            f"{trace.label}: execution order violates per-class deadline "
            f"order at {int(bad.sum())} log position(s), first at index "
            f"{int(idx[0])}")
    return out


def check_trace(trace) -> list[str]:
    """All intra-trace invariants. A `ShardedTrace` runs every per-group
    invariant on each group plus the cross-group linearizability check."""
    if isinstance(trace, ShardedTrace):
        out = check_cross_group_linearizability(trace)
        for g in trace.groups:
            out += check_trace(g)
        return out
    return (check_at_most_once(trace) + check_durable_log(trace)
            + check_deadline_order(trace) + check_sync_coverage(trace))


def check_sync_coverage(trace: CommitTrace,
                        k: float = 4.0,
                        confidence: float = 0.95) -> list[str]:
    """Honest-bound invariant: the sync daemon's reported error
    bound must actually cover the true clock offset. Each evidence row holds
    the pre-correction error of one node at one sync round and the sigma the
    daemon *reported* for that round (grown since its last estimate); the
    fraction of rows with ``|err| <= k * sigma`` must reach ``confidence``.
    A genuine step event legitimately produces one uncovered row per stepped
    node (the daemon only sees the step at the next round), which the 0.95
    confidence absorbs. Silent when the run kept < 20 rows of evidence --
    too few rounds to call the bound dishonest."""
    sync = getattr(trace, "sync", None) or {}
    err, sigma = sync.get("err"), sync.get("sigma")
    if err is None or sigma is None or err.size < 20:
        return []
    covered = np.abs(err) <= k * sigma
    frac = float(covered.mean())
    if frac >= confidence:
        return []
    bad = np.flatnonzero(~covered)
    return [
        f"{trace.label}: sync bound dishonest: reported error bound covers "
        f"the true offset in only {frac:.1%} of {err.size} evidence rows "
        f"(need {confidence:.0%} at {k:g} sigma), first miss at t="
        f"{float(sync['t'][bad[0]]):.3f}s node {int(sync['node'][bad[0]])} "
        f"(|err| {abs(float(err[bad[0]])) * 1e6:.1f}us vs sigma "
        f"{float(sigma[bad[0]]) * 1e6:.1f}us)"]


# ---------------------------------------------------------------------------
# adversarial detection invariants: each fires on the damage its
# paired fault family leaves behind, and stays silent on clean runs
# ---------------------------------------------------------------------------
def check_split_brain(trace: CommitTrace) -> list[str]:
    """Two durable logs hold conflicting entries at the same position.
    Honest Nezha replicas are prefix-consistent -- one log may trail the
    other, but within their common length they agree positionally. Any
    positional uid mismatch means two replicas committed conflicting
    histories (e.g. a LossyAcker relaunched into a stale view it still
    leads, appending on top of its truncated log)."""
    out = []
    rids = sorted(trace.replica_logs)
    packed = {r: _pack(trace.replica_logs[r]["cid"],
                       trace.replica_logs[r]["rid"]) for r in rids}
    for i, a in enumerate(rids):
        for b in rids[i + 1:]:
            m = min(packed[a].size, packed[b].size)
            bad = np.flatnonzero(packed[a][:m] != packed[b][:m])
            if bad.size:
                out.append(
                    f"{trace.label}: split brain: replicas {a} and {b} hold "
                    f"conflicting entries at {int(bad.size)} log position(s), "
                    f"first at index {int(bad[0])}")
    return out


def check_stamp_bias(trace: CommitTrace, bound: float = 100e-6) -> list[str]:
    """Per-proxy deadline-offset estimator: a proxy whose median offset
    (deadline minus honest local send time) deviates from the cross-proxy
    median by more than ``bound`` is stamping biased deadlines. Clock-sync
    error and latency-bound estimation keep honest proxies well inside
    ``bound`` of each other; a SkewedStamper lands its full bias outside.
    Needs >= 3 proxies with >= 8 samples each to attribute blame."""
    pid, doff = trace.stamps["pid"], trace.stamps["doff"]
    if pid.size == 0:
        return []
    med = {}
    for p in np.unique(pid):
        sel = pid == p
        if int(sel.sum()) >= 8:
            med[int(p)] = float(np.median(doff[sel]))
    if len(med) < 3:
        return []
    overall = float(np.median(list(med.values())))
    out = []
    for p, m in sorted(med.items()):
        if abs(m - overall) > bound:
            out.append(
                f"{trace.label}: stamp bias: proxy {p} median deadline "
                f"offset {m * 1e6:.0f}us deviates {abs(m - overall) * 1e6:.0f}us "
                f"from the cross-proxy median (bound {bound * 1e6:.0f}us)")
    return out


def check_durability(trace: CommitTrace) -> list[str]:
    """Durability violation: a crashed replica had acknowledged entries it
    never durably persisted (the LossyAcker hole, exposed on relaunch)."""
    out = []
    for ev in trace.durability:
        if ev["acked"] > ev["persisted"]:
            out.append(
                f"{trace.label}: durability violation: replica "
                f"{ev['replica']} acked {ev['acked']} entries but persisted "
                f"only {ev['persisted']} ({ev['missing']} lost on crash)")
    return out


def check_partition_liveness(trace: CommitTrace) -> list[str]:
    """Fault-window liveness. Partition windows: the majority side keeps
    committing while the minority makes at most in-flight-drain progress,
    under 1% of the majority's (the expected asymmetry -- or nobody
    commits, outright liveness loss). Gray windows:
    the in-window commit rate or fast-path ratio collapses below half the
    clean-operation level. Silent when the run recorded no fault windows."""
    t, fast = trace.commits["t"], trace.commits["fast"]
    out = []
    gray = [w for w in trace.net_windows if w["kind"] == "gray"]
    in_any_gray = np.zeros(t.size, bool)
    for w in gray:
        in_any_gray |= (t >= w["t0"]) & (t < w["t1"])
    gray_span = sum(w["t1"] - w["t0"] for w in gray)
    clean_span = (float(t.max() - t.min()) if t.size else 0.0) - gray_span
    n_out = int((~in_any_gray).sum())
    rate_out = n_out / clean_span if clean_span > 0 else 0.0
    fast_out = float(fast[~in_any_gray].mean()) if n_out else 0.0
    for w in trace.net_windows:
        t0, t1 = w["t0"], w["t1"]
        if t1 <= t0:
            continue
        inside = (t >= t0) & (t < t1)
        n_in = int(inside.sum())
        if w["kind"] == "partition":
            if n_in == 0:
                out.append(
                    f"{trace.label}: liveness lost: zero commits during "
                    f"partition [{t0:.3f}, {t1:.3f})s")
            else:
                # Cut links block at sample time, so a handful of already
                # scheduled deliveries still drain into the minority after
                # the cut; tolerate that, not sustained progress.
                mp = int(w.get("minority_progress", n_in))
                if mp * 100 < n_in:
                    out.append(
                        f"{trace.label}: partition asymmetry: majority "
                        f"committed {n_in} during [{t0:.3f}, {t1:.3f})s "
                        f"while minority {w.get('minority')} made only "
                        f"{mp} durable entries of progress")
        else:  # gray
            rate_in = n_in / (t1 - t0)
            fast_in = float(fast[inside].mean()) if n_in else 0.0
            if n_in == 0 or rate_in < 0.5 * rate_out \
                    or fast_in < 0.5 * fast_out:
                out.append(
                    f"{trace.label}: gray degradation in [{t0:.3f}, "
                    f"{t1:.3f})s: commit rate {rate_in:.0f}/s vs "
                    f"{rate_out:.0f}/s clean, fast ratio {fast_in:.2f} vs "
                    f"{fast_out:.2f} clean")
    return out


def check_cross_group_linearizability(trace) -> list[str]:
    """Cross-group atomicity + global deadline order for multi-key ops
    (sharded backend). Three properties per the MultiOp commit protocol
    (one pre-stamped global deadline, zero coordination rounds):

      torn op      a multi-op durable in SOME involved groups but not all
                   violates atomicity (all-or-nothing durable membership);
      deadline     every involved group must log the op at the identical
                   pre-stamped deadline, bit-for-bit -- a diverging logged
                   deadline means a group re-stamped (re-ordered) the op;
      order        two multi-ops sharing >= 2 groups must appear in the
                   same relative log order in every shared group, and that
                   order must agree with their global deadline order --
                   scoped to groups that sequenced both ops within one
                   epoch batch (a slow-path retry legitimately pushes an
                   entry to a later batch: the vectorized engine's
                   documented windowed approximation, the same scope
                   `check_deadline_order` uses).

    Silent ([]) on non-sharded traces and on runs with no multi-ops."""
    if not isinstance(trace, ShardedTrace) or not trace.multiops:
        return []
    # per-group uid -> log position, plus logged deadlines and batch ids
    gpos = []
    for g in trace.groups:
        gpos.append(({int(u): i for i, u in enumerate(g.log_uids.tolist())},
                     g.log["deadline"], g.log["batch"]))
    out = []
    durable = []                       # (uid, groups, prestamped deadline)
    for uid, info in sorted(trace.multiops.items()):
        grps = info["groups"]
        present = [gi for gi in grps if uid in gpos[gi][0]]
        if not present:
            continue                   # never durable anywhere: clean abandon
        u_str = f"({uid >> 32}, {uid & 0xFFFFFFFF})"
        if len(present) < len(grps):
            missing = sorted(set(grps) - set(present))
            out.append(
                f"{trace.label}: torn multi-op {u_str}: durable in "
                f"group(s) {present} but missing from {missing}")
            continue
        dls = {gi: float(gpos[gi][1][gpos[gi][0][uid]]) for gi in grps}
        bad = {gi: d for gi, d in dls.items() if d != info["deadline"]}
        if bad:
            out.append(
                f"{trace.label}: multi-op {u_str} logged off its "
                f"pre-stamped deadline {info['deadline']:.9f} in group(s) "
                + ", ".join(f"{gi} (at {d:.9f})"
                            for gi, d in sorted(bad.items())))
            continue
        durable.append((uid, grps, info["deadline"]))
    for i, (ua, ga, da) in enumerate(durable):
        for ub, gb, db in durable[i + 1:]:
            shared = sorted(set(ga) & set(gb))
            if len(shared) < 2:
                continue
            # within one epoch batch the log IS whole-batch deadline order,
            # so same-batch positions are a valid order witness; a group
            # that split the pair across batches abstains
            a_first = {}
            for gi in shared:
                pos, _, batch = gpos[gi]
                pa, pb = pos[ua], pos[ub]
                if batch[pa] == batch[pb]:
                    a_first[gi] = pa < pb
            sa = f"({ua >> 32}, {ua & 0xFFFFFFFF})"
            sb = f"({ub >> 32}, {ub & 0xFFFFFFFF})"
            if len(set(a_first.values())) > 1:
                out.append(
                    f"{trace.label}: multi-ops {sa} and {sb} execute in "
                    f"opposite orders across shared groups "
                    f"{sorted(a_first)}")
            elif a_first and da != db \
                    and next(iter(a_first.values())) != (da < db):
                out.append(
                    f"{trace.label}: multi-ops {sa} (deadline {da:.9f}) "
                    f"and {sb} (deadline {db:.9f}) execute against global "
                    f"deadline order in shared groups {sorted(a_first)}")
    return out


def check_sync_degraded(trace: CommitTrace) -> list[str]:
    """Sync-quality degradation: the daemon's reported error bound
    widened well past its synced-era level -- a sync outage let drift accrue
    unbounded, or biased probe paths inflated the robust spread. Compares
    the worst per-round maximum sigma against the 25th percentile of
    per-round maxima (the healthy baseline): degradation means the peak
    exceeds the baseline both relatively (> 1.8x) and absolutely (> +12us).
    A clean drifty run's between-round growth measures ~1.4x / +6us (the
    probe-round cadence bounds how far the reported sigma wanders between
    estimates), so both margins have ~2x headroom. Silent on traces
    without sync evidence."""
    sync = getattr(trace, "sync", None) or {}
    t, sigma = sync.get("t"), sync.get("sigma")
    if t is None or sigma is None or t.size == 0:
        return []
    # per-round (per unique tick) worst reported bound across nodes
    ticks, inv = np.unique(t, return_inverse=True)
    if ticks.size < 4:
        return []
    smax = np.zeros(ticks.size, np.float64)
    np.maximum.at(smax, inv, sigma)
    p25 = float(np.percentile(smax, 25))
    peak = float(smax.max())
    if peak > 1.8 * p25 and peak > p25 + 12e-6:
        at = float(ticks[int(np.argmax(smax))])
        return [
            f"{trace.label}: sync degraded: reported error bound peaked at "
            f"{peak * 1e6:.1f}us (t={at:.3f}s) vs a healthy baseline of "
            f"{p25 * 1e6:.1f}us"]
    return []


def check_sync_step(trace: CommitTrace) -> list[str]:
    """Clock step detection: the daemon flagged a discontinuous
    offset jump (VM migration / leap event) on some node -- an estimate far
    outside what accrued drift could explain since the last round. Silent
    on traces without sync evidence or without step events."""
    sync = getattr(trace, "sync", None) or {}
    events = sync.get("events") or []
    steps = [ev for ev in events if ev.get("kind") == "step"]
    if not steps:
        return []
    return [
        f"{trace.label}: clock step detected on node {int(ev['node'])} at "
        f"t={float(ev['t']):.3f}s (estimated jump "
        f"{float(ev['magnitude']) * 1e6:.0f}us)"
        for ev in steps]


# scenario ``invariant`` name -> its paired checker (the catalog's
# adversarial scenarios each assert exactly their own entry fires)
ADVERSARIAL_CHECKS = {
    "split-brain": check_split_brain,
    "stamp-bias": check_stamp_bias,
    "durability": check_durability,
    "partition-liveness": check_partition_liveness,
    "cross-group": check_cross_group_linearizability,
    "sync-degraded": check_sync_degraded,
    "sync-step": check_sync_step,
}


def check_adversarial(trace) -> list[str]:
    """All adversarial detection invariants. A `ShardedTrace` runs the
    cross-group check once plus every per-group invariant on each group
    (the single-trace checkers are silent on ShardedTrace itself)."""
    if isinstance(trace, ShardedTrace):
        out = check_cross_group_linearizability(trace)
        for g in trace.groups:
            out += check_adversarial(g)
        return out
    out = []
    for fn in ADVERSARIAL_CHECKS.values():
        out += fn(trace)
    return out


def check_equivalent_commits(a: CommitTrace, b: CommitTrace) -> list[str]:
    """Cross-run commit-sequence equivalence (backends, tiers or
    devices): the two runs
    committed exactly the same request set. (Commit *times* differ -- the
    backends sample independent network randomness -- but a request that
    commits on one backend and not the other is a fidelity bug.)"""
    ua, ub = np.unique(a.commit_uids), np.unique(b.commit_uids)
    out = []
    only_a = np.setdiff1d(ua, ub)
    if only_a.size:
        out.append(f"committed on {a.label} but not {b.label}: "
                   f"{_uid_str(only_a)}")
    only_b = np.setdiff1d(ub, ua)
    if only_b.size:
        out.append(f"committed on {b.label} but not {a.label}: "
                   f"{_uid_str(only_b)}")
    return out


def assert_trace_ok(trace: CommitTrace) -> None:
    violations = check_trace(trace)
    assert not violations, "; ".join(violations)


def assert_equivalent_commits(a: CommitTrace, b: CommitTrace) -> None:
    violations = check_equivalent_commits(a, b)
    assert not violations, "; ".join(violations)


# ---------------------------------------------------------------------------
# one-call scenario runner with trace capture
# ---------------------------------------------------------------------------
def run_scenario_with_trace(protocol_name: str, scenario, *,
                            device: Optional[str] = None, config=None, **kw):
    """`repro_torch.sim.scenario.run_scenario`, returning ``(result, trace)``;
    on the card unless ``device="cpu"``. Also fills
    ``result.invariant_violations`` with the number of findings the
    adversarial detection invariants raised on the captured trace."""
    from repro_torch.sim.scenario import run_scenario_on_cluster

    result, cluster = run_scenario_on_cluster(
        protocol_name, scenario, device=device, config=config, **kw)
    trace = CommitTrace.from_cluster(cluster)
    result.invariant_violations = len(check_adversarial(trace))
    result.raw["invariant_violations"] = result.invariant_violations
    if isinstance(trace, ShardedTrace):
        result.cross_group_violations = len(
            check_cross_group_linearizability(trace))
        result.raw["cross_group_violations"] = result.cross_group_violations
    return result, trace


__all__ = [
    "COMMIT_COLS", "LOG_COLS", "CommitTrace", "ShardedTrace",
    "check_at_most_once", "check_durable_log", "check_deadline_order",
    "check_trace", "check_equivalent_commits",
    "check_split_brain", "check_stamp_bias", "check_durability",
    "check_partition_liveness", "check_cross_group_linearizability",
    "check_sync_coverage", "check_sync_degraded", "check_sync_step",
    "check_adversarial", "ADVERSARIAL_CHECKS",
    "assert_trace_ok", "assert_equivalent_commits",
    "run_scenario_with_trace",
]
