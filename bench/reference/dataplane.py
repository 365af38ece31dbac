"""Plain numpy reference of Nezha's DOM data plane, for the benchmark's
`correct` verdict.

What it reproduces. Given a deployment file (bench/configs), the seed and
the exact sequence of public calls a run made (``submit_at``, ``crash_at``,
``relaunch_at``, ``run_for``; `Deployment.replay`), it works out again
everything the system under test derives from them:

  network    the per-message one-way delays and drops of the cloud-fabric
             model (shifted lognormal + bursts + drops, a persistent offset
             per path), drawn from one numpy generator per consensus group
             seeded with the run's seed (+ g * the group stride), in the
             order the system draws them;
  stamping   each proxy stamps send time + the DOM bound: the configured
             percentile of a sliding pool of observed proxy->replica delays
             plus beta * 2 * the clock residual, clamped to (0, D];
             cross-group ops keep the deadline their client pre-stamped;
  DOM        early-buffer admission per replica (the event-ordered
             watermark: a message is admitted iff its deadline exceeds
             every deadline already released when it arrives) and the
             release instant max(deadline, arrival);
  commits    fast path (leader + enough followers whose admitted prefix,
             within the request's key class, equals the leader's) or slow
             path (leader's log modification synced by f followers), the
             commit time at the proxy and at the client;
  logs       the synced log in deadline order, one batch an epoch, each
             entry's view; the speculative tails (admitted, uncommitted)
             with the replicas holding them; client retries after
             ``client_timeout`` up to ``max_retries``;
  recovery   crash and relaunch at epoch boundaries, failure detection,
             the ViewChange and StartView quorums over sampled delays,
             MERGE-LOG (last-normal-view filter, ceil(f/2)+1 majority,
             key3 re-sort), merged entries committed at StartView,
             the rest re-admitted;
  sharding   key -> group routing by the splitmix64 mix, one sub-entry a
             group for a multi-group op at one pre-stamped deadline, and
             the op's client commit at the latest group's (fast iff every
             group's was).

It is written from the protocol's description and the JAX package's staged
numpy tier (stamp, DOM, commit as separate numpy stages, no padding, no
kernels), with no import of the system under test or of JAX. It runs every
epoch one at a time: the system's K-epoch windows and its batched groups
are, by the system's own contract, the same epochs.

Why every comparison is exact. Every time is float64 and every value is
computed by the same IEEE operations in the same order on both sides
(sums left to right, the fetch mean by fold-halves, the percentile by
numpy's linear interpolation), and the random streams are the same
generator in the same order. So a correct run agrees bit for bit and the
limits are 0. ``dtype=np.float32`` gives the control: the same reference
with its time arithmetic in float32, which has to fail those limits.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

PENDING_DTYPE = np.dtype([
    ("t", np.float64), ("t0", np.float64), ("cid", np.int64),
    ("rid", np.int64), ("kcls", np.int64), ("tries", np.int64),
    ("dl", np.float64),
])
LOG_COLS = ("deadline", "cid", "rid", "kcls", "view", "batch", "recovered")
COMMIT_COLS = ("t", "cid", "rid", "fast", "recovered")
_M64 = (1 << 64) - 1
_SPLITMIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)
_GROUP_SALT = 0xC0FFEE5EED5EED00


def pack_uids(cid, rid) -> np.ndarray:
    return np.asarray(cid, np.int64) << 32 | np.asarray(rid, np.int64)


def key_group_np(keys: np.ndarray, groups: int) -> np.ndarray:
    """`key_group` of each uint64 key."""
    keys = np.asarray(keys, np.uint64)
    if groups == 1:
        return np.zeros(keys.shape, np.int64)
    m = np.uint64
    with np.errstate(over="ignore"):
        z = (keys ^ m(_GROUP_SALT)) + m(_SPLITMIX[0])
        z = (z ^ (z >> m(30))) * m(_SPLITMIX[1])
        z = (z ^ (z >> m(27))) * m(_SPLITMIX[2])
        z = z ^ (z >> m(31))
        return ((z >> m(32)) * m(groups) >> m(32)).astype(np.int64)


def key_group(key: int, groups: int) -> int:
    """splitmix64 of (key ^ salt), then a 64x32 multiply-shift into
    [0, groups)."""
    if groups == 1:
        return 0
    z = ((int(key) ^ _GROUP_SALT) + _SPLITMIX[0]) & _M64
    z = ((z ^ (z >> 30)) * _SPLITMIX[1]) & _M64
    z = ((z ^ (z >> 27)) * _SPLITMIX[2]) & _M64
    z ^= z >> 31
    return ((z >> 32) * groups & _M64) >> 32


# ---------------------------------------------------------------------------
# the fabric
# ---------------------------------------------------------------------------
class Fabric:
    """One-way delays and drops: base + persistent path offset + lognormal
    jitter + exponential bursts; drops with a fixed probability."""

    def __init__(self, n_nodes: int, p: dict, seed: int):
        self.p = p
        self.rng = np.random.default_rng(seed)
        self.offset = self.rng.normal(0.0, p["path_offset_sigma"],
                                      size=(n_nodes, n_nodes)).clip(min=0.0)

    def to_all(self, srcs: np.ndarray, n: int, n_dst: int):
        """Message i from srcs[i] to each of destinations 0..n_dst-1."""
        p, rng = self.p, self.rng
        owd = np.full((n, n_dst), p["base_owd"])
        owd += self.offset[srcs[:, None], np.arange(n_dst)[None, :]]
        owd += rng.lognormal(p["lognorm_mu"], p["lognorm_sigma"],
                             size=(n, n_dst))
        burst = rng.random((n, n_dst)) < p["burst_prob"]
        owd += np.where(burst, rng.exponential(p["burst_scale"],
                                               size=(n, n_dst)), 0.0)
        return owd, rng.random((n, n_dst)) < p["drop_prob"]

    def pairs(self, srcs: np.ndarray, dsts: np.ndarray):
        """Message i from srcs[i] to dsts[i]."""
        p, rng = self.p, self.rng
        n = srcs.size
        owd = np.full(n, p["base_owd"])
        owd += self.offset[srcs, dsts]
        owd += rng.lognormal(p["lognorm_mu"], p["lognorm_sigma"], size=n)
        burst = rng.random(n) < p["burst_prob"]
        owd += np.where(burst, rng.exponential(p["burst_scale"], size=n),
                        0.0)
        return owd, rng.random(n) < p["drop_prob"]


# ---------------------------------------------------------------------------
# DOM and commit classification
# ---------------------------------------------------------------------------
def watermark_admit(d: np.ndarray, a: np.ndarray) -> np.ndarray:
    """[N], [N, R] -> admitted [N, R]. Per receiver, events in time order:
    the arrival of each message (a test) and its release at max(d, a) (an
    update of the released-deadline watermark). Ties: a release whose
    deadline is later than its arrival goes before every arrival at that
    instant; otherwise events at one instant go by message index, the
    arrival first. A test passes iff its deadline exceeds the watermark
    and it arrived at all."""
    N, R = a.shape
    out = np.zeros((N, R), bool)
    if N == 0:
        return out
    idx = np.arange(N)
    inf = np.asarray(np.inf, d.dtype)
    contrib = np.where(np.isfinite(d), d, -inf)
    none = np.full(N, -inf)
    for r in range(R):
        ar = a[:, r]
        times = np.concatenate([ar, np.maximum(d, ar)])
        aux = np.concatenate([(N + idx) * 2,
                              (np.where(d > ar, 0, N) + idx) * 2 + 1])
        order = np.lexsort((aux, times))
        run = np.maximum.accumulate(np.concatenate([none, contrib])[order])
        excl = np.concatenate([[-inf], run[:-1]])
        test = order < N
        m = order[test]
        out[m, r] = (d[m] > excl[test]) & np.isfinite(ar[m])
    return out


def fold_sum(x: np.ndarray) -> float:
    """Sum by folding halves over the next power of two (zeros padded)."""
    m = x.size
    if m == 0:
        return 0.0
    p = 1 << max(0, int(m - 1).bit_length()) if m > 1 else 1
    if p != m:
        x = np.concatenate([x, np.zeros(p - m, x.dtype)])
    while x.size > 1:
        h = x.size // 2
        x = x[:h] + x[h:]
    return x[0]


def classify(deadlines, arrivals, admitted, release, reply, leader: int,
             f: int, batch_delay, kcls, order):
    """(commit time, fast, committed) [N] at the proxy."""
    N, R = arrivals.shape
    inf = np.asarray(np.inf, arrivals.dtype)
    fq = 1 + f + math.ceil(f / 2)
    sq = 1 + f
    if kcls is not None and N:
        order = order[np.argsort(kcls[order], kind="stable")]
    adm = admitted[order]
    dis = adm != adm[:, leader][:, None]
    cum = np.cumsum(dis, axis=0) - dis
    if kcls is not None and N:
        ks = kcls[order]
        brk = ks[1:] != ks[:-1]
        starts = np.r_[0, np.flatnonzero(brk) + 1]
        seg = np.cumsum(np.r_[0, brk.astype(np.int64)])
        cum = cum - cum[starts][seg]
    match = (cum == 0)[np.argsort(order, kind="stable")]
    fast_reply = np.where(admitted, release + reply, inf)
    ok = admitted & match & admitted[:, [leader]]
    ok_t = np.where(ok, fast_reply, inf)
    kth = (np.sort(ok_t, axis=1)[:, fq - 1] if fq - 1 < R
           else np.full(N, inf))
    fast_t = np.where(np.isfinite(ok_t[:, leader]), kth, inf)
    fast_t = np.maximum(fast_t, ok_t[:, leader])
    lead_t = np.where(admitted[:, leader], release[:, leader],
                      arrivals[:, leader])
    lead_t = np.where(np.isfinite(arrivals[:, leader]), lead_t, inf)
    sync_t = lead_t[:, None] + batch_delay + reply
    fin = np.isfinite(reply)
    cnt = int(fin.sum())
    fetch = (inf if cnt == 0 else arrivals.dtype.type(
        3.0 * (fold_sum(np.where(fin, reply, 0.0).ravel()) / cnt)))
    have_t = np.where(np.isfinite(arrivals), arrivals, lead_t[:, None] + fetch)
    slow_reply = np.maximum(sync_t, have_t) + reply
    slow_reply[:, leader] = lead_t + reply[:, leader]
    slow_t = np.maximum(np.sort(slow_reply, axis=1)[:, sq - 1],
                        slow_reply[:, leader])
    commit = np.minimum(fast_t, slow_t)
    committed = np.isfinite(commit)
    return commit, (fast_t <= slow_t) & committed, committed


def percentile(a: np.ndarray, q: float) -> float:
    """numpy's linear-interpolation percentile of a 1-D array."""
    pos = q / 100.0 * (a.size - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    part = np.partition(a, [lo, hi])
    lo_v, hi_v = float(part[lo]), float(part[hi])
    t = pos - lo
    if t == 0.0 or lo_v == hi_v:
        return lo_v
    if t < 0.5:
        return lo_v + t * (hi_v - lo_v)
    return hi_v - (hi_v - lo_v) * (1.0 - t)


# ---------------------------------------------------------------------------
# pending requests and replica logs
# ---------------------------------------------------------------------------
class Pending:
    """Submitted attempts waiting for their epoch, in submission order."""

    def __init__(self):
        self.rows = np.empty(0, PENDING_DTYPE)

    def extend(self, rows: np.ndarray) -> None:
        self.rows = np.concatenate([self.rows, rows])

    def pop_due(self, horizon: float) -> np.ndarray:
        due = self.rows["t"] <= horizon
        if not due.any():
            return np.empty(0, PENDING_DTYPE)
        out = np.sort(self.rows[due], order="t", kind="stable")
        self.rows = self.rows[~due]
        return out

    def min_time(self) -> float:
        return float(self.rows["t"].min()) if self.rows.size else np.inf

    def _mask(self, cid, rid) -> np.ndarray:
        return np.isin(pack_uids(self.rows["cid"], self.rows["rid"]),
                       pack_uids(cid, rid))

    def pop_uids(self, cid, rid) -> np.ndarray:
        m = self._mask(cid, rid)
        out = self.rows[m].copy()
        self.rows = self.rows[~m]
        return out

    def reschedule(self, cid, rid, t: float) -> None:
        m = self._mask(cid, rid)
        self.rows["t"][m] = np.minimum(self.rows["t"][m], t)

    def uids(self) -> np.ndarray:
        return pack_uids(self.rows["cid"], self.rows["rid"])


class Logs:
    """The synced log (one shared copy; live replicas sync it by epoch
    end), per-replica sync points and last normal views, and the
    speculative tails: uncommitted entries with the replicas that admitted
    them."""

    def __init__(self, n: int, f: int):
        self.n, self.f = n, f
        self.view = 0
        self.sync_point = np.zeros(n, np.int64)
        self.last_normal_view = np.zeros(n, np.int64)
        self.length = 0
        self.tail_deadline = -np.inf
        self.cols = {c: [] for c in LOG_COLS}
        self.spec = self._no_spec()
        self.replay = np.empty(0, np.int64)
        self.batch = 0

    def _no_spec(self) -> dict:
        return {"deadline": np.empty(0), "cid": np.empty(0, np.int64),
                "rid": np.empty(0, np.int64), "kcls": np.empty(0, np.int64),
                "admitted": np.empty((0, self.n), bool)}

    def _append(self, deadline, cid, rid, kcls, batch, view, recovered):
        k = len(deadline)
        for c, v in (("deadline", np.asarray(deadline, np.float64)),
                     ("cid", np.asarray(cid, np.int64)),
                     ("rid", np.asarray(rid, np.int64)),
                     ("kcls", np.asarray(kcls, np.int64)),
                     ("view", np.full(k, view, np.int64)),
                     ("batch", np.full(k, batch, np.int64)),
                     ("recovered", np.full(k, recovered, bool))):
            self.cols[c].append(v)
        self.length += k
        if k:
            self.tail_deadline = float(np.asarray(deadline)[-1])

    def _drop_spec(self, mask) -> None:
        if mask.any():
            self.spec = {c: v[~mask] for c, v in self.spec.items()}

    def observe(self, e: dict) -> None:
        batch = self.batch
        self.batch += 1
        committed = e["committed"]
        uids = pack_uids(e["cid"], e["rid"])
        ex = e["order"][committed[e["order"]]]
        ex_uids = uids[ex]
        if self.replay.size:
            rep = np.isin(ex_uids, self.replay)
            if rep.any():
                done = ex_uids[rep][e["delivered"][ex[rep]]]
                self.replay = self.replay[~np.isin(self.replay, done)]
                ex, ex_uids = ex[~rep], ex_uids[~rep]
        if ex.size:
            self._append(e["deadlines"][ex], e["cid"][ex], e["rid"][ex],
                         e["kcls"][ex], batch, self.view, False)
            lost = ~e["delivered"][ex]
            if lost.any():
                self.replay = np.concatenate([self.replay, ex_uids[lost]])
        alive = e["alive"]
        self.sync_point[alive] = self.length
        self.last_normal_view[alive] = self.view
        spec = ~committed & e["admitted"].any(axis=1)
        if spec.any() and self.replay.size:
            spec &= ~np.isin(uids, self.replay)
        if self.spec["deadline"].size:
            self._drop_spec(np.isin(
                pack_uids(self.spec["cid"], self.spec["rid"]),
                uids[spec | committed]))
        if spec.any():
            new = {"deadline": e["deadlines"][spec], "cid": e["cid"][spec],
                   "rid": e["rid"][spec], "kcls": e["kcls"][spec],
                   "admitted": e["admitted"][spec]}
            self.spec = {c: np.concatenate([self.spec[c], new[c]])
                         for c in self.spec}

    def drop_uids(self, cid, rid) -> None:
        if self.spec["deadline"].size:
            self._drop_spec(np.isin(
                pack_uids(self.spec["cid"], self.spec["rid"]),
                pack_uids(cid, rid)))

    def on_crash(self, r: int) -> None:
        if self.spec["admitted"].size:
            self.spec["admitted"][:, r] = False
        self.sync_point[r] = 0
        self.last_normal_view[r] = -1

    def view_change(self, new_view: int, alive: np.ndarray) -> dict:
        """MERGE-LOG over the live replicas with the highest last normal
        view: entries beyond the synced prefix held by ceil(f/2)+1 of them,
        not behind the prefix's last deadline, one attempt a request, in
        (deadline, client, request) order."""
        lnv = self.last_normal_view
        qualified = alive & (lnv == lnv[alive].max())
        s = self.spec
        d, cid, rid = s["deadline"], s["cid"], s["rid"]
        counts = s["admitted"][:, qualified].sum(axis=1)
        keep = (counts >= math.ceil(self.f / 2) + 1) \
            & (d >= self.tail_deadline)
        merged = np.empty(0, np.int64)
        if keep.any():
            order = np.lexsort((rid, cid, d))
            order = order[keep[order]]
            _, first = np.unique(pack_uids(cid[order], rid[order]),
                                 return_index=True)
            merged = order[np.sort(first)]
        keep = np.zeros(d.size, bool)
        keep[merged] = True
        rec = {c: s[c][merged] for c in ("deadline", "cid", "rid", "kcls")}
        dropped = {c: s[c][~keep] for c in ("deadline", "cid", "rid")}
        batch = self.batch
        self.batch += 1
        if merged.size:
            self._append(rec["deadline"], rec["cid"], rec["rid"],
                         rec["kcls"], batch, new_view, True)
        self.view = new_view
        self.sync_point[alive] = self.length
        self.last_normal_view[alive] = new_view
        self.spec = self._no_spec()
        return {"recovered": rec, "dropped": dropped}

    def columns(self) -> dict:
        dt = dict(deadline=np.float64, cid=np.int64, rid=np.int64,
                  kcls=np.int64, view=np.int64, batch=np.int64,
                  recovered=bool)
        return {c: (np.concatenate(v) if v else np.empty(0, dt[c]))
                for c, v in self.cols.items()}


# ---------------------------------------------------------------------------
# one consensus group
# ---------------------------------------------------------------------------
@dataclass
class _ViewChange:
    view: int
    leader: int
    t_start: float
    t_done: float


@dataclass
class GroupConfig:
    f: int
    n_proxies: int
    n_clients: int
    seed: int
    net: dict
    dom: dict
    clock_residual: float
    epoch: float
    commutative: bool
    client_timeout: float
    max_retries: int
    heartbeat_timeout: float
    viewchange_resend: float
    leader_batch_delay: float


class Group:
    """One Nezha group: 2f + 1 replicas, proxies, the epoch loop, faults
    and view changes. Records each epoch's batch size by phase."""

    def __init__(self, cfg: GroupConfig, dtype=np.float64):
        self.cfg = cfg
        self.ft = np.dtype(dtype)
        self.f = cfg.f
        self.n = 2 * cfg.f + 1
        self.net = Fabric(self.n + cfg.n_proxies + cfg.n_clients, cfg.net,
                          cfg.seed)
        self.logs = Logs(self.n, cfg.f)
        self.alive = np.ones(self.n, bool)
        self.now = 0.0
        self.pending = Pending()
        self.key_classes: dict[tuple, int] = {}
        self.faults: list[tuple[float, tuple]] = []
        self.view = 0
        self.vc: Optional[_ViewChange] = None
        self.floor = 0.0
        self.view_change_events: list[dict] = []
        self.pool = np.zeros(0)
        self.latencies: list[np.ndarray] = []
        self.commits: list[tuple] = []
        self.n_requests = 0
        self.n_fast = 0
        self.batches = 0
        self.epochs = 0
        self.recovered = 0
        self.dropped = 0
        self.phase = "warm"
        self.epoch_sizes: dict[str, list[int]] = {}

    # -- calls ---------------------------------------------------------------
    def key_class(self, keys: tuple) -> int:
        if not keys:
            return -1
        return self.key_classes.setdefault(tuple(keys),
                                           len(self.key_classes))

    def add_rows(self, t, cid, rid, kcls, dl) -> None:
        rows = np.empty(t.size, PENDING_DTYPE)
        rows["t"], rows["t0"], rows["cid"], rows["rid"] = t, t, cid, rid
        rows["kcls"], rows["tries"], rows["dl"] = kcls, 0, dl
        self.pending.extend(rows)
        self.n_requests += int(t.size)

    def fault_at(self, t: float, r: int, alive: bool) -> None:
        bisect.insort(self.faults, (float(t), ("alive", int(r), alive)),
                      key=lambda e: e[0])
        self._apply_faults(self.now)

    def _apply_faults(self, up_to: float) -> None:
        while self.faults and self.faults[0][0] <= up_to:
            _, (_, r, alive) = self.faults.pop(0)
            was = bool(self.alive[r])
            self.alive[r] = alive
            if was and not alive:
                self.logs.on_crash(r)

    # -- view changes ----------------------------------------------------------
    def _viable(self, v: int) -> int:
        while not self.alive[v % self.n]:
            v += 1
        return v

    def _delivered(self, srcs, dsts) -> np.ndarray:
        owd, drop = self.net.pairs(srcs, dsts)
        penalty = np.zeros(owd.size)
        for _ in range(64):
            if not drop.any():
                break
            idx = np.flatnonzero(drop)
            penalty[idx] += self.cfg.viewchange_resend
            owd2, d2 = self.net.pairs(srcs[idx], dsts[idx])
            owd[idx] = owd2
            drop[:] = False
            drop[idx] = d2
        return owd + penalty

    def _start_vc(self, now: float, view: int) -> _ViewChange:
        leader = view % self.n
        others = np.flatnonzero(self.alive)
        others = others[others != leader]
        if others.size < self.f:
            return _ViewChange(view, leader, now, np.inf)
        t_detect = now + self.cfg.heartbeat_timeout
        vc_in = self._delivered(others, np.full(others.size, leader))
        t_q = t_detect + float(np.partition(vc_in, self.f - 1)[self.f - 1])
        sv_out = self._delivered(np.full(others.size, leader), others)
        t_done = t_q + self.cfg.leader_batch_delay \
            + float(np.partition(sv_out, self.f - 1)[self.f - 1])
        return _ViewChange(view, leader, now, t_done)

    def _update_view(self, now: float) -> None:
        ok = self.alive
        if not ok.any():
            self.vc = None
            return
        while True:
            if self.vc is None:
                if ok[self.view % self.n]:
                    return
                self.vc = self._start_vc(now, self._viable(self.view + 1))
                return
            vc = self.vc
            if not ok[vc.leader]:
                self.vc = self._start_vc(now, self._viable(vc.view + 1))
                return
            if np.count_nonzero(ok) < self.f + 1:
                vc.t_done = np.inf
                return
            if not np.isfinite(vc.t_done):
                self.vc = self._start_vc(now, vc.view)
                return
            if now >= vc.t_done:
                self._complete_vc()
                continue
            return

    def _complete_vc(self) -> None:
        vc = self.vc
        res = self.logs.view_change(vc.view, self.alive)
        rec, dropped = res["recovered"], res["dropped"]
        self.view = vc.view
        self.floor = max(self.floor, vc.t_done)
        self.vc = None
        self.recovered += int(rec["cid"].size)
        self.dropped += int(dropped["cid"].size)
        self.view_change_events.append({
            "view": vc.view, "leader": vc.leader, "t_start": vc.t_start,
            "t_done": vc.t_done, "recovered": int(rec["cid"].size),
            "dropped": int(dropped["cid"].size)})
        if dropped["cid"].size:
            self.pending.reschedule(dropped["cid"], dropped["rid"], vc.t_done)
        if rec["cid"].size:
            self._deliver_recovered(rec, vc.leader, vc.t_done)

    def _deliver_recovered(self, rec: dict, leader: int, t_rec: float):
        cfg = self.cfg
        k = int(rec["cid"].size)
        pnodes = self.n + rec["cid"] % cfg.n_proxies
        leg1 = self._delivered(np.full(k, leader), pnodes)
        cnodes = self.n + cfg.n_proxies + rec["cid"]
        leg2 = self._delivered(pnodes, cnodes)
        at = t_rec + leg1 + leg2
        rows = self.pending.pop_uids(rec["cid"], rec["rid"])
        if rows.size == 0:
            found = np.zeros(k, bool)
        else:
            kp = pack_uids(rows["cid"], rows["rid"])
            o = np.argsort(kp)
            kr = pack_uids(rec["cid"], rec["rid"])
            pos = np.searchsorted(kp[o], kr)
            found = kp[o][np.minimum(pos, kp.size - 1)] == kr
            self.latencies.append(at[found] - rows["t0"][o][pos[found]])
        nf = int(found.sum())
        self.commits.append((at[found], rec["cid"][found], rec["rid"][found],
                             np.zeros(nf, bool), np.ones(nf, bool)))

    # -- the epoch loop ----------------------------------------------------------
    def run_for(self, duration: float) -> None:
        horizon = self.now + duration
        ep = self.cfg.epoch
        while self.now < horizon:
            self._apply_faults(self.now)
            self._update_view(self.now)
            cand = [horizon, self.now + ep,
                    self.faults[0][0] if self.faults else np.inf]
            if self.vc is not None and np.isfinite(self.vc.t_done):
                cand.append(self.vc.t_done)
            end = min(cand)
            if self.vc is not None and np.isfinite(self.vc.t_done):
                pass                    # stalled until StartView
            elif self.vc is not None or not self.alive.any():
                while True:
                    due = self.pending.pop_due(end)
                    if due.size == 0:
                        break
                    self.batches += 1
                    self._retry(due)
            else:
                dies = None
                for t, (_, r, alive) in self.faults:
                    if t > end:
                        break
                    if not alive:
                        if dies is None:
                            dies = np.full(self.n, np.inf)
                        dies[r] = min(dies[r], t)
                while True:
                    due = self.pending.pop_due(end)
                    if due.size == 0:
                        break
                    self._absorb(due, self._epoch(due, self.view % self.n,
                                                  dies))
            self.epochs += 1
            self.now = end

    def _retry(self, failed: np.ndarray) -> None:
        failed = failed.copy()
        failed["tries"] += 1
        gone = failed["tries"] > self.cfg.max_retries
        if gone.any():
            self.latencies.append(np.full(int(gone.sum()), np.inf))
            self.logs.drop_uids(failed["cid"][gone], failed["rid"][gone])
            failed = failed[~gone]
        failed["t"] += self.cfg.client_timeout
        self.pending.extend(failed)

    def _absorb(self, due: np.ndarray, e: dict) -> None:
        self.batches += 1
        dl = e["delivered"]
        self.latencies.append(e["latency"][dl])
        self.n_fast += int(np.sum(e["fast"] & dl))
        if dl.any():
            i = np.flatnonzero(dl)
            self.commits.append((e["at_client"][i], e["cid"][i], e["rid"][i],
                                 e["fast"][i], np.zeros(i.size, bool)))
        if not dl.all():
            self._retry(due[~dl])

    def _bound(self, owd: np.ndarray) -> float:
        d = self.cfg.dom
        new = np.ravel(owd)
        if new.size:
            self.pool = np.concatenate([self.pool, new])[-d["window"] * self.n:]
        if self.pool.size == 0:
            return d["clamp_d"]
        margin = d["beta"] * 2.0 * self.cfg.clock_residual
        b = percentile(self.pool, d["percentile"]) + margin
        return b if 0.0 < b < d["clamp_d"] else d["clamp_d"]

    def _epoch(self, due: np.ndarray, leader: int, dies) -> dict:
        """One epoch's batch through sample, stamp, DOM, commit, deliver
        and log; times in ``self.ft``."""
        cfg, n, ft = self.cfg, self.n, self.ft.type
        N = due.size
        self.epoch_sizes.setdefault(self.phase, []).append(N)
        cid, rid = due["cid"].copy(), due["rid"].copy()
        kcls = due["kcls"].copy()
        pnodes = n + cid % cfg.n_proxies
        cnodes = n + cfg.n_proxies + cid
        c2p, drop = self.net.pairs(cnodes, pnodes)
        c2p[drop] = np.inf
        p2c, drop = self.net.pairs(pnodes, cnodes)
        p2c[drop] = np.inf
        owd, lost = self.net.to_all(pnodes, N, n)
        reply, _ = self.net.to_all(pnodes, N, n)
        # stamp
        bound = ft(self._bound(owd.astype(ft)))
        stamp = due["t"].astype(ft) + c2p.astype(ft)
        deadlines = stamp + bound
        pre = due["dl"]
        if (pre > 0).any():
            deadlines = np.where(pre > 0, pre.astype(ft), deadlines)
        arrivals = stamp[:, None] + owd.astype(ft)
        arrivals[lost] = np.inf
        arrivals[:, ~self.alive] = np.inf
        arrivals = np.maximum(arrivals, ft(self.floor))
        if dies is not None:
            arrivals[arrivals > dies.astype(ft)[None, :]] = np.inf
        reply = reply.astype(ft)
        reply[:, ~self.alive] = np.inf
        # DOM
        admitted = watermark_admit(deadlines, arrivals)
        release = np.where(admitted, np.maximum(deadlines[:, None], arrivals),
                           np.inf).astype(ft)
        # commit
        order = np.argsort(deadlines, kind="stable")
        commit, fast, committed = classify(
            deadlines, arrivals, admitted, release, reply, leader, self.f,
            ft(cfg.leader_batch_delay),
            kcls if cfg.commutative else None, order)
        # deliver
        at_client = commit + p2c.astype(ft)
        lat = at_client - due["t0"].astype(ft)
        lat[~committed] = np.inf
        e = {"cid": cid, "rid": rid, "order": order, "committed": committed,
             "fast": fast, "admitted": admitted, "alive": self.alive.copy(),
             "deadlines": deadlines.astype(np.float64),
             "kcls": kcls if cfg.commutative else np.full(N, -1, np.int64),
             "at_client": at_client.astype(np.float64),
             "latency": lat.astype(np.float64),
             "delivered": committed & np.isfinite(lat)}
        self.logs.observe(e)
        return e

    # -- results ---------------------------------------------------------------
    def commit_columns(self) -> dict:
        dt = dict(t=np.float64, cid=np.int64, rid=np.int64, fast=bool,
                  recovered=bool)
        return {c: (np.concatenate([np.asarray(r[i]) for r in self.commits])
                    if self.commits else np.empty(0, dt[c]))
                for i, c in enumerate(COMMIT_COLS)}

    def all_latencies(self) -> np.ndarray:
        return (np.concatenate(self.latencies) if self.latencies
                else np.zeros(0))

    @property
    def view_changes(self) -> int:
        return self.vc.view if self.vc is not None else self.view


def summarize(lat: np.ndarray, n_requests: int, n_fast: int) -> dict:
    lat = np.asarray([x for x in lat if np.isfinite(x)], dtype=float)
    c = int(lat.size)
    return {"n_requests": int(n_requests), "committed": c,
            "fast_commit_ratio": n_fast / max(c, 1),
            "median_latency": float(np.median(lat)) if c else float("nan"),
            "p90_latency": float(np.percentile(lat, 90)) if c else float("nan"),
            "mean_latency": float(lat.mean()) if c else float("nan")}


# ---------------------------------------------------------------------------
# a deployment: G groups behind one key space
# ---------------------------------------------------------------------------
@dataclass
class Deployment:
    """The reference of one deployment file: G groups (G = 1 is the plain
    3-replica group), routing, multi-group ops, results."""

    conf: dict
    n_clients: int
    seed: int
    dtype: type = np.float64
    groups: list = field(default_factory=list)

    def __post_init__(self):
        c = self.conf
        self.G = int(c["groups"])
        self.stride = int(c.get("group_seed_stride", 7919))
        self.margin = float(c.get("multiop_margin", 2.5e-3))
        self.groups = [Group(self._group_cfg(g), self.dtype)
                       for g in range(self.G)]
        self.spec_window = [g.logs._no_spec() for g in self.groups]
        self.next_rid = [0] * self.n_clients
        self.uids: list[int] = []
        self.t0s: list[float] = []
        self.multi: dict[int, dict] = {}

    def _group_cfg(self, g: int) -> GroupConfig:
        c = self.conf
        return GroupConfig(
            f=int(c["f"]), n_proxies=int(c["n_proxies"]),
            n_clients=self.n_clients, seed=self.seed + g * self.stride,
            net=dict(c["net"]), dom=dict(c["dom"]),
            clock_residual=float(c["clock_residual_sigma"]),
            epoch=float(c["epoch_duration"]),
            commutative=bool(c["commutative"]),
            client_timeout=float(c["client_timeout"]),
            max_retries=int(c["max_retries"]),
            heartbeat_timeout=float(c["heartbeat_timeout"]),
            viewchange_resend=float(c["viewchange_resend"]),
            leader_batch_delay=float(c["leader_batch_delay"]))

    def submit_block(self, t: np.ndarray, cid: np.ndarray, keys: list):
        """Submit requests in order: request i at t[i] from client cid[i]
        on keys[i]; each client numbers its requests 0, 1, ... ."""
        n = int(t.size)
        if n == 0:
            return
        cid = np.asarray(cid, np.int64)
        nr = np.asarray(self.next_rid, np.int64)
        o = np.argsort(cid, kind="stable")
        cs = cid[o]
        rank = np.arange(n) - np.searchsorted(cs, cs)
        rid = np.empty(n, np.int64)
        rid[o] = nr[cs] + rank
        self.next_rid = (nr + np.bincount(cid, minlength=nr.size)).tolist()
        uids = pack_uids(cid, rid)
        self.uids.extend(uids.tolist())
        self.t0s.extend(t.tolist())
        rows, grp, sub, dl = [], [], [], []
        if self.G == 1:
            rows, grp, sub = range(n), [0] * n, keys
            dl = [0.0] * n
        else:
            multi = [i for i, k in enumerate(keys) if len(k) != 1]
            single = np.ones(n, bool)
            single[multi] = False
            first = np.fromiter((k[0] if len(k) == 1 else 0 for k in keys),
                                np.uint64, n)
            g1 = key_group_np(first, self.G)
            idx = np.flatnonzero(single)
            rows, grp = idx.tolist(), g1[idx].tolist()
            sub = [keys[i] for i in rows]
            dl = [0.0] * len(rows)
            for i in multi:
                ks = keys[i]
                ga = [key_group(k, self.G) for k in ks] if ks else [0]
                gs = sorted(set(ga))
                if len(gs) == 1:
                    rows.append(i), grp.append(gs[0]), sub.append(ks)
                    dl.append(0.0)
                    continue
                d = float(t[i]) + self.margin
                self.multi[int(uids[i])] = {"groups": tuple(gs),
                                            "deadline": d}
                for g in gs:
                    rows.append(i), grp.append(g), dl.append(d)
                    sub.append(tuple(k for k, kg in zip(ks, ga) if kg == g))
        rows = np.asarray(rows, np.int64)
        grp = np.asarray(grp, np.int64)
        dl = np.asarray(dl, np.float64)
        order = np.lexsort((rows, grp))
        bounds = np.searchsorted(grp[order], np.arange(self.G + 1))
        for g in range(self.G):
            sel = order[bounds[g]:bounds[g + 1]]
            if sel.size == 0:
                continue
            r = rows[sel]
            kc = [self.groups[g].key_class(sub[j]) for j in sel.tolist()]
            self.groups[g].add_rows(t[r], cid[r], rid[r],
                                    np.asarray(kc, np.int64), dl[sel])

    def replay(self, log) -> None:
        """Make a run's calls again: ("phase", name), ("block", block:
        its faults, then its requests) and ("run", duration). The
        speculative tails are kept as they stand when the drain begins
        (the end of the timed window)."""
        for kind, arg in log:
            if kind == "block":
                for t, what, r in arg.faults:
                    g, rr = divmod(int(r), self.groups[0].n)
                    self.groups[g].fault_at(t, rr, what == "relaunch")
                self.submit_block(arg.t, arg.cid, arg.keys)
            elif kind == "run":
                for grp in self.groups:
                    grp.run_for(arg)
            elif kind == "phase":
                for grp in self.groups:
                    grp.phase = arg
                if arg == "drain":
                    self.spec_window = [
                        {c: v.copy() for c, v in g.logs.spec.items()}
                        for g in self.groups]

    # -- results ---------------------------------------------------------------
    def epoch_sizes(self, phase: str) -> list[int]:
        return [n for g in self.groups for n in g.epoch_sizes.get(phase, [])]

    def summary(self) -> dict:
        gs = self.groups
        extra = {"batches": sum(g.batches for g in gs),
                 "epochs": sum(g.epochs for g in gs),
                 "view_changes": sum(g.view_changes for g in gs),
                 "recovered_entries": sum(g.recovered for g in gs),
                 "dropped_speculative": sum(g.dropped for g in gs)}
        if self.G == 1:
            g = gs[0]
            out = summarize(g.all_latencies(), g.n_requests, g.n_fast)
        else:
            lat, n_fast = self._merged_latencies()
            out = summarize(lat, len(self.uids), n_fast)
            extra["cross_group_ops"] = len(self.multi)
        out.update(extra)
        return out

    def _merged_latencies(self):
        recs = [r for g in self.groups for r in g.commits]
        if recs:
            t_all = np.concatenate([np.asarray(r[0]) for r in recs])
            cid = np.concatenate([np.asarray(r[1]) for r in recs])
            rid = np.concatenate([np.asarray(r[2]) for r in recs])
            fast = np.concatenate([np.asarray(r[3]) for r in recs])
            uids = pack_uids(cid, rid)
        else:
            t_all, fast = np.zeros(0), np.zeros(0, bool)
            uids = np.zeros(0, np.int64)
        all_u = np.asarray(self.uids, np.int64)
        all_t0 = np.asarray(self.t0s, np.float64)
        o = np.argsort(all_u)
        su, st0 = all_u[o], all_t0[o]
        marr = np.asarray(sorted(self.multi), np.int64)
        mm = np.isin(uids, marr)
        parts, committed, n_fast = [], [], 0
        if (~mm).any():
            parts.append(t_all[~mm] - st0[np.searchsorted(su, uids[~mm])])
            n_fast += int(fast[~mm].sum())
            committed.append(uids[~mm])
        if mm.any():
            m_u, m_t, m_f = uids[mm], t_all[mm], fast[mm]
            o2 = np.argsort(m_u, kind="stable")
            m_u, m_t, m_f = m_u[o2], m_t[o2], m_f[o2]
            uniq, start = np.unique(m_u, return_index=True)
            counts = np.diff(np.append(start, m_u.size))
            expected = np.asarray([len(self.multi[int(u)]["groups"])
                                   for u in uniq])
            complete = counts == expected
            tmax = np.maximum.reduceat(m_t, start)
            allfast = np.minimum.reduceat(m_f.astype(np.int64),
                                          start).astype(bool)
            parts.append(tmax[complete]
                         - st0[np.searchsorted(su, uniq[complete])])
            n_fast += int(allfast[complete].sum())
            committed.append(uniq[complete])
        cu = np.concatenate(committed) if committed else np.zeros(0, np.int64)
        pu = np.concatenate([g.pending.uids() for g in self.groups])
        gone = np.setdiff1d(all_u, np.union1d(cu, pu))
        if gone.size:
            parts.append(np.full(gone.size, np.inf))
        lat = np.concatenate(parts) if parts else np.zeros(0)
        return lat, n_fast

    def observation(self) -> dict:
        """What the comparison reads, in the harness's common form."""
        return {
            "groups": [{
                "log": g.logs.columns(),
                "commits": g.commit_columns(),
                "view_changes": list(g.view_change_events),
                "spec": {c: v.copy() for c, v in g.logs.spec.items()},
                "spec_window": w,
            } for g, w in zip(self.groups, self.spec_window)],
            "summary": self.summary(),
            "multiops": {u: (tuple(m["groups"]), float(m["deadline"]))
                         for u, m in self.multi.items()},
        }


__all__ = ["Deployment", "Group", "GroupConfig", "watermark_admit",
           "classify", "key_group", "pack_uids"]
