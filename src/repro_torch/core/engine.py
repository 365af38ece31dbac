"""Port of `repro/core/engine.py`: Nezha's fused DOM data plane on torch.

One epoch runs as four stages over an `EpochState`:

  SampleStage   bulk per-epoch network sampling on the host (numpy
                generators, so every random stream matches the reference);
  FusedEpochStage  stamp -> DOM admission + release -> commit classification
                as one torch program on the engine's device (`_build_epoch_
                body`): ring-pool OWD fold + sliding-percentile deadline
                bound, the mean-reply fetch estimate, admission through the
                `dom_admit` kernel, the stable deadline order through the
                `dom_release` kernel, and the quorum arithmetic;
  DeliverStage  commit delivery at the client and latency accounting;
  LogStage      cross-epoch replica-log bookkeeping (`ReplicaLogState`), the
                state the vectorized MERGE-LOG consults at a view change.

Every time is float64 end to end, and the body keeps the reference's
reduction orders (fold-halves sum, the percentile's branch structure, the
host-divided ``percentile / 100``), so it matches the reference's staged
numpy tier bit for bit, on the CPU and on the card alike.

**K-epoch windows**: `DomEngine.run_window` loops the same body over K
fault-free epochs (K in `SCAN_K_BUCKETS`) with the (pool, ptr, cnt) ring
carry kept on the device, and pulls the K epochs' outputs to the host in
ONE transfer at the end of the window. Host-side sampling, delivery and
log bookkeeping still run per epoch in order, so a window equals the same
epochs run one at a time, bit for bit.

**Groups**: the body takes every per-epoch operand with a leading axis of
G consensus groups (the reference `jax.vmap`s its body over that axis).
A single engine runs it at G = 1; the sharded backend
(`repro_torch.core.sharded`) runs the epochs of all its groups as one
call, one launch of each DOM kernel for all G. Rows of different groups
never mix, so each group's outputs equal its G = 1 run bit for bit.

Batches are padded to power-of-two buckets (pad lanes carry +inf times and
are invisible to real rows); a window shares one bucket across its epochs.
Tensors move host -> device once per epoch (or window) and back once.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.core.clocksync import ClockSyncDaemon, estimate_offsets
from repro_torch.core.quorum import fast_quorum_size, slow_quorum_size
from repro_torch.core.recovery import (
    merge_logs_vectorized,
    pack_uids,
    qualified_replicas,
)
from repro_torch.core.sanitizer import Sanitizer
from repro_torch.kernels.ops import (
    dom_admit_device,
    dom_deadline_order_device,
    resolve_device,
)


# ---------------------------------------------------------------------------
# Pending-submission buffer (structured, amortized growth)
# ---------------------------------------------------------------------------
PENDING_DTYPE = np.dtype([
    ("t", np.float64),       # next attempt time (sim s)
    ("t0", np.float64),      # original submission time (latency baseline)
    ("cid", np.int64),       # submitting client id
    ("rid", np.int64),       # per-client request id
    ("kcls", np.int64),      # interned commutativity class (-1 = global)
    ("tries", np.int64),     # completed attempts (retry model)
    ("dl", np.float64),      # pre-stamped deadline (0.0 = stamp normally;
    #   > 0 = the sharded multi-op layer fixed this entry's global deadline
    #   before routing, so every group orders it at the same slot)
])


class PendingBuffer:
    """Growable structured array of pending submissions.

    Replaces the Python list-of-tuples buffer: appends are O(1) amortized and
    `pop_due` is a vectorized mask + stable time-sort instead of two list
    comprehensions over every pending request.
    """

    def __init__(self, capacity: int = 1024):
        self._buf = np.empty(max(capacity, 1), dtype=PENDING_DTYPE)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def _reserve(self, need: int) -> None:
        if self._buf.size < need:
            cap = self._buf.size
            while cap < need:
                cap *= 2
            grown = np.empty(cap, dtype=PENDING_DTYPE)
            grown[: self._n] = self._buf[: self._n]
            self._buf = grown

    def append(self, t: float, cid: int, rid: int, kcls: int,
               t0: Optional[float] = None, tries: int = 0,
               dl: float = 0.0) -> None:
        self._reserve(self._n + 1)
        self._buf[self._n] = (t, t if t0 is None else t0, cid, rid, kcls,
                              tries, dl)
        self._n += 1

    def extend(self, rows: np.ndarray) -> None:
        """Bulk re-enqueue of PENDING_DTYPE rows (the retry path)."""
        self._reserve(self._n + rows.size)
        self._buf[self._n: self._n + rows.size] = rows
        self._n += rows.size

    def min_time(self) -> float:
        if self._n == 0:
            return np.inf
        return float(self._buf["t"][: self._n].min())

    def has_prestamped(self) -> bool:
        """Any pending entry carrying a pre-stamped deadline (dl > 0)?
        Such epochs need the per-epoch step program (it takes the extra
        pre_dl operand); the K-epoch window excludes them."""
        if self._n == 0:
            return False
        return bool((self._buf["dl"][: self._n] > 0).any())

    def uids(self) -> np.ndarray:
        """Packed uids of every pending attempt (sharded abandonment
        accounting: a request neither committed nor pending anywhere was
        given up on)."""
        view = self._buf[: self._n]
        return pack_uids(view["cid"], view["rid"])

    def pop_due(self, horizon: float) -> np.ndarray:
        """Remove and return all entries with t <= horizon, time-sorted."""
        with spans.span("pop_due"):
            view = self._buf[: self._n]
            due_mask = view["t"] <= horizon
            if not due_mask.any():
                return np.empty(0, dtype=PENDING_DTYPE)
            due = np.sort(view[due_mask], order="t", kind="stable")
            self._keep(~due_mask)
            return due

    def _keep(self, keep_mask: np.ndarray) -> None:
        rest = self._buf[: self._n][keep_mask].copy()
        self._n = rest.size
        if self._buf.size < rest.size:       # pragma: no cover - cannot shrink
            self._buf = np.empty(rest.size, dtype=PENDING_DTYPE)
        self._buf[: self._n] = rest

    def _uid_mask(self, cid: np.ndarray, rid: np.ndarray) -> np.ndarray:
        view = self._buf[: self._n]
        return np.isin(pack_uids(view["cid"], view["rid"]),
                       pack_uids(cid, rid))

    def pop_uids(self, cid: np.ndarray, rid: np.ndarray) -> np.ndarray:
        """Remove and return the pending attempts of the given requests
        (the recovery path: a merged speculative entry commits through the
        view change, so its client stops retrying)."""
        if self._n == 0:
            return np.empty(0, dtype=PENDING_DTYPE)
        mask = self._uid_mask(cid, rid)
        taken = self._buf[: self._n][mask].copy()
        if taken.size:
            self._keep(~mask)
        return taken

    def reschedule_uids(self, cid: np.ndarray, rid: np.ndarray,
                        t: float) -> None:
        """Pull the given requests' next attempt up to ``t`` at the latest
        (proxy retransmission of un-merged entries at StartView)."""
        if self._n == 0:
            return
        mask = self._uid_mask(cid, rid)
        view = self._buf[: self._n]
        view["t"][mask] = np.minimum(view["t"][mask], t)


def _pow2_bucket(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length()) if n > 1 else 1


# Allowed K-epochs-per-window lengths for the fault-free fast path; windows
# are padded with empty epochs up to a bucket size.
SCAN_K_BUCKETS = (4, 16, 64)

_F64 = torch.float64
_INF = float("inf")


def _tree_mean_fetch(reply: torch.Tensor) -> torch.Tensor:
    """`_fetch_estimate` of each group of [G, N, R] reply delays -> [G]:
    3x the mean finite delay, summed in the fold-halves `_tree_sum` order.
    That order is pow2-padding invariant, so a group's padded rows (+inf,
    masked to 0.0) reduce to its exact host value."""
    G = reply.shape[0]
    fin = torch.isfinite(reply)
    cnt = fin.reshape(G, -1).sum(dim=1)
    x = torch.where(fin, reply, 0.0).reshape(G, -1)
    p = _pow2_bucket(x.shape[1])
    if p != x.shape[1]:
        x = torch.cat([x, x.new_zeros(G, p - x.shape[1])], dim=1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return torch.where(cnt > 0, 3.0 * (x[:, 0] / torch.clamp_min(cnt, 1)),
                       _INF)


def _classify(arrivals, admitted, release, reply_owd, leader, f: int, *,
              mod_owd, batch_delay: float, order, kcls=None,
              force_slow=None):
    """The quorum arithmetic of `classify_commits`, in float64 over a
    leading axis of G groups: arrivals, admitted, release, reply_owd and
    mod_owd [G, N, R], leader [G] int64, ``order`` the stable deadline
    order [G, N], ``kcls`` [G, N] key classes (None: every request
    conflicts with every other), ``force_slow`` [G, N] (None: no request
    is barred from the fast path) -> (commit time, fast, committed) [G, N].

    The one copy of it: `classify_commits` runs it at G = 1, the epoch body
    over its groups. Rows of different groups never mix."""
    G, N, R = arrivals.shape
    dev = arrivals.device
    fq = fast_quorum_size(f)
    sq = slow_quorum_size(f)
    lead_at = leader[:, None, None].expand(G, N, 1)
    lead_col = (torch.arange(R, device=dev) == leader[:, None])[:, None, :]

    def at_leader(x):           # [G, N, R] -> [G, N]: the leader's column
        return x.gather(2, lead_at)[..., 0]

    # --- hash consistency: prefix-set equality per replica vs leader ------
    korder = order
    if kcls is not None:
        # per key class (S8.2): regroup the deadline order by class
        # (stable), giving the (class, deadline) order
        korder = order.gather(1, torch.sort(kcls.gather(1, order), dim=1,
                                            stable=True).indices)
    adm_sorted = admitted.gather(1, korder[..., None].expand(G, N, R))
    disagree = (adm_sorted != at_leader(adm_sorted)[..., None]).to(
        torch.int64)
    cum_disagree = torch.cumsum(disagree, dim=1) - disagree   # exclusive
    if kcls is not None:
        # segmented: subtract each class's running total at its start
        ks = kcls.gather(1, korder)
        is_start = torch.cat(
            [torch.ones((G, 1), dtype=torch.bool, device=dev),
             ks[:, 1:] != ks[:, :-1]], dim=1)
        start_pos = torch.cummax(
            torch.where(is_start, torch.arange(N, device=dev), 0),
            dim=1).values
        cum_disagree = cum_disagree - cum_disagree.gather(
            1, start_pos[..., None].expand(G, N, R))
    inv = torch.empty_like(korder).scatter_(
        1, korder, torch.arange(N, device=dev).expand(G, N))
    prefix_match = (cum_disagree == 0).gather(
        1, inv[..., None].expand(G, N, R))
    # --- fast quorum: leader + (fq - 1) matching followers, by reply time;
    # the k-th value of the sorted row is the value np.partition picks
    lead_admitted = at_leader(admitted)
    fast_reply_t = torch.where(admitted, release + reply_owd, _INF)
    fast_hash_ok = admitted & prefix_match & lead_admitted[..., None]
    ok_t = torch.where(fast_hash_ok, fast_reply_t, _INF)
    ok_lead = at_leader(ok_t)
    ok_kth = (torch.sort(ok_t, dim=-1).values[..., fq - 1]
              if fq - 1 < R
              else torch.full((G, N), _INF, dtype=_F64, device=dev))
    fast_commit_t = torch.where(torch.isfinite(ok_lead), ok_kth, _INF)
    fast_commit_t = torch.maximum(fast_commit_t, ok_lead)
    if force_slow is not None:
        # deadline-capped requests (SD.2.4): slow path only
        fast_commit_t = torch.where(force_slow, _INF, fast_commit_t)
    # --- slow path ----------------------------------------------------------
    arr_lead = at_leader(arrivals)
    leader_t = torch.where(lead_admitted, at_leader(release), arr_lead)
    leader_t = torch.where(torch.isfinite(arr_lead), leader_t, _INF)
    sync_t = leader_t[..., None] + batch_delay + mod_owd
    # a follower syncs m only once it has it (or fetched it: + 2 hops)
    fetch = _tree_mean_fetch(reply_owd)
    have_t = torch.where(torch.isfinite(arrivals), arrivals,
                         leader_t[..., None] + fetch[:, None, None])
    slow_reply_t = torch.maximum(sync_t, have_t) + reply_owd
    slow_reply_t = torch.where(lead_col, leader_t[..., None] + reply_owd,
                               slow_reply_t)       # the leader's own reply
    slow_kth = torch.sort(slow_reply_t, dim=-1).values[..., sq - 1]
    slow_commit_t = torch.maximum(slow_kth, at_leader(slow_reply_t))
    # --- verdicts -------------------------------------------------------------
    commit_t = torch.minimum(fast_commit_t, slow_commit_t)
    committed = torch.isfinite(commit_t)
    return commit_t, (fast_commit_t <= slow_commit_t) & committed, committed


def classify_commits_device(deadlines, arrivals, admitted, release,
                            reply_owd, leader: int, f: int, mod_owd=None,
                            leader_batch_delay: float = 50e-6, key_ids=None,
                            order=None, force_slow=None):
    """`classify_commits` on tensors of one device, without the pull:
    deadlines [N], arrivals, admitted, release, reply_owd and mod_owd
    (default reply_owd) [N, R], key_ids, order and force_slow [N] ->
    (commit time, fast, committed) [N]. Without ``order``, the stable
    deadline order comes from the `dom_release` kernel (its plain version
    on the CPU)."""
    dev = arrivals.device
    N = arrivals.shape[0]
    if N == 0:
        return (arrivals.new_zeros(0),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    if order is None:
        order = dom_deadline_order_device(deadlines)
    outs = _classify(
        arrivals[None], admitted[None], release[None], reply_owd[None],
        torch.tensor([int(leader)], device=dev), f,
        mod_owd=(reply_owd if mod_owd is None else mod_owd)[None],
        batch_delay=float(leader_batch_delay), order=order[None],
        kcls=None if key_ids is None else key_ids[None],
        force_slow=None if force_slow is None else force_slow[None])
    return tuple(o[0] for o in outs)


def classify_commits(deadlines, arrivals, admitted, release, reply_owd,
                     leader: int, f: int, mod_owd=None,
                     leader_batch_delay: float = 50e-6, key_ids=None,
                     order=None, force_slow=None, *,
                     device="cuda") -> dict:
    """Classify each request's commit path and commit time at the proxy.

    Port of `repro/core/engine.py::classify_commits`, with the reference's
    arguments (numpy in, numpy out): deadlines [N], arrivals, admitted,
    release, reply_owd and mod_owd (default reply_owd) [N, R], key_ids
    [N] commutativity classes, ``order`` [N] a deadline-sorted index
    order, force_slow [N]. Fast path: admitted at the leader and at enough
    followers whose log prefix (the admitted requests of smaller deadline,
    within the request's key class when ``key_ids`` is given) matches the
    leader's; slow path: the leader's log-modification, synced and
    acknowledged by a slow quorum.

    A float64 torch program on ``device`` (the card unless the caller asks
    for the CPU), `classify_commits_device` between one upload and one
    pull: without ``order``, the stable deadline order comes from the
    `dom_release` kernel. Returns commit_time, fast, committed [N]."""
    dev = resolve_device(device)

    def up(x, dtype=np.float64):
        return None if x is None else torch.as_tensor(
            np.asarray(x, dtype), device=dev)

    outs = classify_commits_device(
        up(deadlines), up(arrivals), up(admitted, bool), up(release),
        up(reply_owd), leader, f, mod_owd=up(mod_owd),
        leader_batch_delay=leader_batch_delay,
        key_ids=up(key_ids, np.int64), order=up(order, np.int64),
        force_slow=up(force_slow, bool))
    return dict(zip(("commit_time", "fast", "committed"), _pull(list(outs))))


def _build_epoch_body(f: int, use_kcls: bool, use_cap: bool = False):
    """The torch epoch body behind the single-epoch step, the K window and
    the sharded backend's batched epoch.

    A mirror of the reference's StampStage + DomStage + `classify_commits`,
    run in float64 on the operands' device over a leading axis of G groups
    (the reference `jax.vmap`s its body over the same axis). The two
    host-owned per-epoch scalars are computed in the body, per group, from
    carried state:

      bound  -- this epoch's observed OWDs fold into a fixed-size ring
                pool (the device twin of `DomEngine.owd_pool`), then the
                sliding percentile + clock margin is selected, bit-identical
                to `update_bound`/`_partition_percentile`;
      fetch  -- the mean-reply estimate via the fold-halves sum,
                bit-identical to `_fetch_estimate` (in `_classify`, the
                commit classification it shares with `classify_commits`).

    Signature: body(pool [G, W], ptr [G], cnt [G], <epoch operands [G, N]
    and [G, N, R], alive [G, R]>, leader [G], n_valid [G], <config scalars
    shared by every group>, floor [G], <fault operands with a leading G>)
    -> ((pool, ptr, cnt), [stamp, deadlines, arrivals, admitted, release,
    commit_t, fast, committed, order (+ sync est, sigma)], bound [G]).
    ``leader``, ``n_valid`` and ``floor`` are host arrays, uploaded here;
    ``ptr`` and ``cnt`` are int64 device tensors, so nothing here waits for
    the device. ``order`` is the stable deadline order from the
    `dom_release` kernel: the log's execution order. The modeled sync
    round's [M, M] operands have no group axis (a single engine only).
    """
    def pool_fold(pool, ptr, cnt, obs, n_valid):
        # Ring-buffer fold of each group's observed OWD samples, row-major
        # over its valid rows -- the device twin of update_bound's
        # `concat(pool, obs)[-W:]`: when more than W samples would land,
        # the oldest overflow is skipped before writing. Write targets are
        # distinct; masked lanes land in the extra slot W, which is cut off.
        G, W = pool.shape
        n_pad, R = obs.shape[1:]
        m = n_valid * R
        m_kept = torch.clamp_max(m, W)
        skip = (m - m_kept)[:, None]
        k = torch.arange(n_pad * R, device=pool.device)[None, :]
        write = (k >= skip) & (k < m[:, None])
        tgt = torch.where(write, (ptr[:, None] + k - skip) % W, W)
        buf = torch.cat([pool, pool.new_zeros(G, 1)], dim=1)
        buf.scatter_(1, tgt, obs.reshape(G, -1))
        return buf[:, :W], (ptr + m_kept) % W, torch.clamp_max(cnt + m, W)

    def pool_percentile(pool, cnt, pq01, margin, clamp_d):
        # Mirror of update_bound: sort-select the two order statistics (+inf
        # fills the unfilled tail) and interpolate exactly like
        # `_partition_percentile` (numpy's _lerp branch structure, separate
        # multiply and add). pq01 is percentile/100 divided on the host.
        W = pool.shape[1]
        srt = torch.sort(pool, dim=1).values
        pos = pq01 * (cnt - 1).to(_F64)
        fl = torch.floor(pos)
        lo = torch.clamp(fl.to(torch.int64), 0, W - 1)[:, None]
        hi = torch.clamp(torch.ceil(pos).to(torch.int64), 0, W - 1)[:, None]
        lo_v = srt.gather(1, lo)[:, 0]
        hi_v = srt.gather(1, hi)[:, 0]
        t = pos - fl
        r = torch.where(t < 0.5, lo_v + t * (hi_v - lo_v),
                        hi_v - (hi_v - lo_v) * (1.0 - t))
        pct = torch.where((t == 0.0) | (lo_v == hi_v), lo_v, r)
        bound = pct + margin
        bound = torch.where((bound > 0.0) & (bound < clamp_d), bound, clamp_d)
        return torch.where(cnt > 0, bound, clamp_d)

    def body(pool, ptr, cnt, t, c2p, owd_pr, drop_pr, reply_owd, alive,
             kcls, leader, n_valid, pq01, margin, clamp_d, batch_delay, cap,
             floor, dies_at=None, stamp_off=None, arr_off=None,
             pair_drop=None, pair_delay=None, pre_dl=None,
             sync_theta=None, sync_rtt=None, sync_safety=None,
             sync_floor=None):
        G, N, R = owd_pr.shape
        dev = owd_pr.device
        leader = torch.as_tensor(np.asarray(leader, np.int64), device=dev)
        n_valid = torch.as_tensor(np.asarray(n_valid, np.int64), device=dev)
        floor = torch.as_tensor(np.asarray(floor, np.float64), device=dev)
        lead_at = leader[:, None, None].expand(G, N, 1)

        def at_leader(x):       # [G, N, R] -> [G, N]: the leader's column
            return x.gather(2, lead_at)[..., 0]

        # Per-pair network faults (Partition / GrayLink): extra delay joins
        # the effective OWD before anything observes it, per-pair drops
        # extend the fabric's own drop mask.
        owd_eff = owd_pr if pair_delay is None else owd_pr + pair_delay
        drop_eff = drop_pr if pair_drop is None else drop_pr | pair_drop
        # --- bound: sliding-percentile deadline bound ----------------------
        # Fold BEFORE selecting: this epoch's samples are part of its bound.
        obs = owd_eff
        if stamp_off is not None:
            obs = owd_eff + arr_off - stamp_off[..., None]
        pool, ptr, cnt = pool_fold(pool, ptr, cnt, obs, n_valid)
        bound = pool_percentile(pool, cnt, pq01, margin, clamp_d)
        # dead replicas reply never (the fetch estimate excludes them too)
        reply = torch.where(alive[:, None, :], reply_owd, _INF)
        # --- stamp: proxy stamping + deadline bounding ---------------------
        # stamp_off: proxy clock-read error folded into the deadline value;
        # arr_off: replica clock-read error shifting each receiver's local
        # frame. Clock-fault-free epochs carry neither.
        stamp = t + c2p
        deadlines = stamp + bound[:, None]
        if stamp_off is not None:
            deadlines = deadlines + stamp_off
        if pre_dl is not None:
            # pre-stamped global deadlines (dl > 0) override LAST
            deadlines = torch.where(pre_dl > 0, pre_dl, deadlines)
        arrivals = torch.where(drop_eff | ~alive[:, None, :], _INF,
                               stamp[..., None] + owd_eff)
        # recovery stall: nothing releases before `floor` (StartView); a
        # zero floor is the identity on the positive arrival times
        arrivals = torch.maximum(arrivals, floor[:, None, None])
        if dies_at is not None:
            # in-flight messages to a replica dying at the epoch's end are
            # never received
            arrivals = torch.where(arrivals > dies_at[:, None, :], _INF,
                                   arrivals)
        # --- dom: watermark admission + release (receiver-local frames) ----
        a_loc = arrivals if arr_off is None else arrivals + arr_off
        admitted = dom_admit_device(deadlines, a_loc)
        release = torch.where(admitted,
                              torch.maximum(deadlines[..., None], a_loc), _INF)
        if arr_off is not None:
            release = release - arr_off
        # --- deadline cap (SD.2.4): the leader releases far-future
        # deadlines at arrival; those requests are barred from the fast path
        lead_col = (torch.arange(R, device=dev) == leader[:, None])[:, None, :]
        if use_cap:
            a_lead = at_leader(a_loc)
            capped = torch.isfinite(a_lead) & (deadlines > a_lead + cap)
            admitted = admitted | (lead_col & capped[..., None])
            release = torch.where(lead_col & capped[..., None], arrivals,
                                  release)
        # --- commit: the shared quorum arithmetic over the kernel's order ----
        order = dom_deadline_order_device(deadlines)
        commit_t, fast, committed = _classify(
            arrivals, admitted, release, reply, leader, f, mod_owd=reply,
            batch_delay=batch_delay, order=order,
            kcls=kcls if use_kcls else None,
            force_slow=capped if use_cap else None)
        outs = [stamp, deadlines, arrivals, admitted, release, commit_t,
                fast, committed, order]
        if sync_theta is not None:
            # a modeled sync round's per-node reductions run in the body
            # over the [M, M] probe operands this epoch carries
            outs += list(estimate_offsets(sync_theta, sync_rtt, torch,
                                          sync_safety, sync_floor))
        return (pool, ptr, cnt), outs, bound

    return body


def _tree_sum(x: np.ndarray) -> float:
    """Fold-halves binary-tree sum of a 1-D float64 array.

    Deterministic and pow2-padding-invariant: zero-padding to ANY larger
    power of two folds away exactly (v + 0.0 == v bitwise), so the fused
    device programs -- which reduce the same values at pow2-padded batch
    shape with masked lanes contributing 0.0 -- produce the bit-identical
    total.  This is the ONE summation order shared by the host mirror and the
    epoch body for the mean-reply fetch estimate.
    """
    m = x.size
    if m == 0:
        return 0.0
    p = _pow2_bucket(m)
    if p != m:
        x = np.concatenate([x, np.zeros(p - m)])
    while x.size > 1:
        h = x.size // 2
        x = x[:h] + x[h:]
    return float(x[0])


def _fetch_estimate(reply_owd: np.ndarray) -> float:
    """3x the mean finite reply delay: the slow-path fetch detour estimate.

    Reduced in the canonical `_tree_sum` order so the epoch body's
    `tree_mean_fetch` matches bit for bit.
    """
    fin = np.isfinite(reply_owd)
    cnt = int(fin.sum())
    if cnt == 0:
        return float(np.inf)
    return 3.0 * (_tree_sum(np.where(fin, reply_owd, 0.0).ravel()) / cnt)


_NP_DTYPES = {torch.float64: np.float64, torch.bool: np.bool_,
              torch.int64: np.int64, torch.int32: np.int32}


def _pull(tensors: list) -> list[np.ndarray]:
    """Copy device tensors to host numpy arrays in ONE transfer: the bytes
    of every tensor are packed into one buffer on the device first (widest
    dtypes first, so every host view stays aligned)."""
    pack = sorted(range(len(tensors)),
                  key=lambda i: -tensors[i].element_size())
    flat = [tensors[i].contiguous().reshape(-1).view(torch.uint8)
            for i in pack]
    host = torch.cat(flat).cpu().numpy()
    out: list = [None] * len(tensors)
    at = 0
    for i, b in zip(pack, flat):
        n = b.shape[0]
        t = tensors[i]
        out[i] = host[at:at + n].view(_NP_DTYPES[t.dtype]).reshape(
            tuple(t.shape))
        at += n
    return out


@dataclass
class EpochState:
    """Mutable per-epoch blackboard the stages fill in, in order."""

    # inputs
    t: np.ndarray                       # [N] attempt times (this submission)
    t0: np.ndarray                      # [N] original submit times (latency)
    cid: np.ndarray                     # [N] client ids
    rid: np.ndarray                     # [N] per-client request ids
    kcls: Optional[np.ndarray]          # [N] commutativity classes (or None)
    alive: np.ndarray                   # [R] replica liveness this epoch
    leader: int                         # leader this epoch
    release_floor: float = 0.0          # replicas release nothing before this
    #   instant (the StartView time of a just-completed view change: messages
    #   arriving during the recovery stall sit in early buffers until it)
    dies_at: Optional[np.ndarray] = None    # [R] death instants inside this
    #   epoch (inf = survives): an epoch cut short by a crash event still has
    #   messages in flight to the dying replica -- those arriving after its
    #   death are never received, which is what leaves speculative entries
    #   on the survivors for MERGE-LOG to recover
    # SampleStage
    proxy_nodes: Optional[np.ndarray] = None
    c2p: Optional[np.ndarray] = None    # [N] client->proxy OWD (inf = dropped)
    p2c: Optional[np.ndarray] = None    # [N] proxy->client reply OWD
    owd_pr: Optional[np.ndarray] = None     # [N, R] proxy->replica OWD
    drop_pr: Optional[np.ndarray] = None    # [N, R] multicast drops
    reply_owd: Optional[np.ndarray] = None  # [N, R] replica->proxy reply OWD
    # Clock-fault offsets (scenario `ClockFault` events; None = synced).
    # A faulty proxy clock shifts the deadline VALUE each of its messages
    # carries; a faulty replica clock shifts when that replica *observes*
    # arrivals/deadlines (its whole local frame), i.e. every admission
    # comparison and release instant at that receiver.
    clock_stamp_off: Optional[np.ndarray] = None  # [N] proxy-clock read error
    clock_arr_off: Optional[np.ndarray] = None    # [N, R] replica-clock read error
    # Per-pair network-fault operands (Partition / GrayLink events; None =
    # clean): extra proxy->replica drops and path delay for this epoch's
    # (message, replica) pairs, gathered from the engine's per-(proxy,
    # replica) fault state by SampleStage. The reverse (replica->proxy)
    # effects are folded into reply_owd directly -- pure data, no operand.
    pair_drop: Optional[np.ndarray] = None    # [N, R] extra drops (bool)
    pair_delay: Optional[np.ndarray] = None   # [N, R] extra path delay (s)
    # Pre-stamped deadlines (sharded MultiOp entries; None = all stamped
    # normally). Where > 0, the value REPLACES the proxy-computed deadline
    # after all stamping/offset math -- the cross-group global slot.
    pre_deadline: Optional[np.ndarray] = None  # [N] fixed deadlines (0=none)
    # Modeled sync round: a probe round due at this epoch's boundary
    # rides the dispatch as [M, M] operands (M = replicas + proxies); the
    # in-program estimator returns per-node (est, sigma), which the daemon
    # folds into corrections/bounds. None on round-free epochs.
    sync_theta: Optional[np.ndarray] = None   # [M, M] NTP offset samples
    sync_rtt: Optional[np.ndarray] = None     # [M, M] selected-probe RTTs
    sync_est: Optional[np.ndarray] = None     # [M] estimator output
    sync_sigma: Optional[np.ndarray] = None   # [M] measured error bounds
    # StampStage
    bound: float = 0.0                  # DOM latency bound this epoch
    stamp: Optional[np.ndarray] = None  # [N] proxy stamp times
    deadlines: Optional[np.ndarray] = None  # [N]
    arrivals: Optional[np.ndarray] = None   # [N, R]
    # DomStage
    admitted: Optional[np.ndarray] = None   # [N, R]
    release: Optional[np.ndarray] = None    # [N, R]
    # CommitStage
    commit_time: Optional[np.ndarray] = None  # [N] commit at proxy
    fast: Optional[np.ndarray] = None
    committed: Optional[np.ndarray] = None    # [N] protocol-level commit
    exec_order: Optional[np.ndarray] = None   # [N] the kernel's deadline order (the
    #   execution/log order; LogStage appends committed entries along it)
    # DeliverStage
    commit_at_client: Optional[np.ndarray] = None  # [N]
    latency: Optional[np.ndarray] = None           # [N] (inf = undelivered)
    delivered: Optional[np.ndarray] = None    # [N] committed AND the reply
    #   reached the client (drives client-side retry + latency accounting)


class Stage:
    name = "stage"

    def run(self, s: EpochState, eng: "DomEngine") -> None:
        raise NotImplementedError


class SampleStage(Stage):
    """Bulk network sampling for the epoch batch, one rng stream."""

    name = "sample"

    def run(self, s, eng):
        with spans.span("sample"):
            self._sample(s, eng)

    def _sample(self, s, eng):
        cfg = eng.cfg
        n = eng.n
        N = s.t.size
        s.proxy_nodes = eng.proxy_nodes(s.cid % cfg.n_proxies)
        if cfg.co_locate_proxies:       # Nezha-Non-Proxy: no client<->proxy hops
            s.c2p = np.zeros(N)
            s.p2c = np.zeros(N)
        elif getattr(cfg, "client_proxy_lan", 0.0) > 0.0:
            # WAN mode (S9.8): proxies live in the client's zone -- both
            # client legs take the fixed LAN delay, not the WAN fabric.
            s.c2p = np.full(N, cfg.client_proxy_lan)
            s.p2c = np.full(N, cfg.client_proxy_lan)
        else:
            cnodes = eng.client_nodes(s.cid)
            c2p, drop_cp = eng.net.sample_owd_pairs(cnodes, s.proxy_nodes)
            # A lost message on either client leg leaves the attempt
            # uncommitted at the client (inf latency); the cluster's retry
            # model then re-issues it after client_timeout.
            c2p[drop_cp] = np.inf
            s.c2p = c2p
            # Reply path sampled per actual submitting client node.
            p2c, drop_pc = eng.net.sample_owd_pairs(s.proxy_nodes, cnodes)
            p2c[drop_pc] = np.inf
            s.p2c = p2c
        replicas = list(range(n))
        s.owd_pr, s.drop_pr = eng.net.sample_owd_matrix(s.proxy_nodes, N, replicas)
        # replica -> proxy replies (symmetric path statistics)
        s.reply_owd, _ = eng.net.sample_owd_matrix(s.proxy_nodes, N, replicas)
        # Clock-fault read errors (Appendix D): one N(mu, sigma) sample per
        # proxy stamp and per (message, replica) observation, from a separate
        # rng stream so fault-free runs stay bit-identical to before. Sampled
        # here, on the host, so every run consumes identical variates.
        if eng.clocks_faulty:
            pids = np.asarray(s.cid) % cfg.n_proxies
            s.clock_stamp_off = eng.rng.normal(eng.proxy_clock[pids, 0],
                                               eng.proxy_clock[pids, 1])
            s.clock_arr_off = eng.rng.normal(
                eng.replica_clock[None, :, 0], eng.replica_clock[None, :, 1],
                size=(N, n))
        if eng.pairs_faulty:
            # Per-pair faults (Partition / GrayLink): gather this epoch's
            # (message, replica) fault rows from the per-(proxy, replica)
            # state. Gray draws come from the engine's fault rng stream
            # (like clock faults) in ONE fixed order -- forward drop,
            # forward delay, reverse drop, reverse delay -- so every run
            # consumes identical variates and fault-free runs draw nothing.
            pids = np.asarray(s.cid) % cfg.n_proxies
            blk = eng._pair_block[pids]                 # [N, R]
            gdp = eng._pair_gray_drop[pids]
            gmu = eng._pair_mu[pids]
            gsg = eng._pair_sigma[pids]
            delayed = (gmu > 0.0) | (gsg > 0.0)
            pair_drop = blk.copy()
            if gdp.any():
                pair_drop |= eng.rng.random((N, n)) < gdp
            s.pair_drop = pair_drop
            delay = np.zeros((N, n))
            if delayed.any():
                delay = np.where(
                    delayed, np.maximum(0.0, eng.rng.normal(gmu, gsg)), 0.0)
            s.pair_delay = delay
            # Reverse leg (replica->proxy replies): fold the same per-pair
            # faults into reply_owd before it becomes a fused operand --
            # blocked/dropped replies never arrive, gray delay adds on.
            reply = s.reply_owd.copy()
            if delayed.any():
                reply = reply + np.where(
                    delayed, np.maximum(0.0, eng.rng.normal(gmu, gsg)), 0.0)
            rdrop = blk.copy()
            if gdp.any():
                rdrop |= eng.rng.random((N, n)) < gdp
            reply[rdrop] = np.inf
            s.reply_owd = reply
        if eng.stampers_biased:
            # SkewedStamper: a deterministic stamp bias is exactly a proxy
            # clock-read offset -- the carried deadline VALUE shifts while
            # true send/arrival instants do not, and the receiver-measured
            # OWD observations absorb -bias. Reuses the clock stamp_off /
            # arr_off operand variant (no new fused specialization).
            pids = np.asarray(s.cid) % cfg.n_proxies
            bias = eng.proxy_stamp_bias[pids]
            if s.clock_stamp_off is None:
                s.clock_stamp_off = bias
                s.clock_arr_off = np.zeros((N, n))
            else:
                s.clock_stamp_off = s.clock_stamp_off + bias
        if eng.sync_active:
            # Modeled sync: the daemon's effective residual offsets
            # (truth minus applied corrections, advanced to this epoch's
            # boundary) ARE the clock read errors -- a proxy's residual
            # shifts the deadline values it stamps, a replica's shifts its
            # whole local frame. Folded additively like SkewedStamper so
            # injected clock faults still compose on top.
            ds = eng.clocksync
            pids = np.asarray(s.cid) % cfg.n_proxies
            soff = ds.stamp_err(pids)
            aoff = np.tile(ds.arr_err(), (N, 1))
            if s.clock_stamp_off is None:
                s.clock_stamp_off = soff
                s.clock_arr_off = aoff
            else:
                s.clock_stamp_off = s.clock_stamp_off + soff
                s.clock_arr_off = s.clock_arr_off + aoff
            if ds.pending is not None:
                # a due probe round rides this epoch's dispatch
                _, theta, rtt = ds.pending
                s.sync_theta = theta
                s.sync_rtt = rtt


class FusedEpochStage(Stage):
    """Stamp -> dom -> commit as one torch program on the engine's device.

    Builds the pow2-padded operands on the host (one group: a leading axis
    of 1), runs `DomEngine.step` (the epoch body of `_build_epoch_body`),
    and takes the outputs back in one transfer. The host advances its numpy
    pool mirror (`update_bound`) in lockstep; its value is bit-identical to
    the body's fold by construction.
    """

    name = "fused"

    def run(self, s, eng):
        with spans.span("dispatch", device=True):
            self._dispatch(s, eng)

    def _dispatch(self, s, eng):
        cfg = eng.cfg
        N = s.t.size
        R = eng.n
        # The PRE-fold ring-pool snapshot goes to the device; the body folds
        # this epoch's samples itself.
        pool, ptr, cnt = eng.device_pool_state()
        s.bound = eng.update_bound(eng.observed_owd_samples(s))
        rep = s.reply_owd.copy()
        rep[:, ~s.alive] = np.inf
        n_pad = _pow2_bucket(N)
        # Pad lanes: +inf attempt time -> +inf stamp/deadline/arrival, never
        # admitted, never committed -- invisible to the real rows.
        t = np.full((1, n_pad), np.inf)
        t[0, :N] = s.t
        c2p = np.zeros((1, n_pad))
        c2p[0, :N] = s.c2p
        owd = np.zeros((1, n_pad, R))
        owd[0, :N] = s.owd_pr
        drop = np.ones((1, n_pad, R), dtype=bool)
        drop[0, :N] = s.drop_pr
        # +inf reply pads: row-local quorum arithmetic never sees them AND
        # the fetch mean excludes them
        reply = np.full((1, n_pad, R), np.inf)
        reply[0, :N] = s.reply_owd
        kcls = np.full((1, n_pad), -1, np.int64)
        if s.kcls is not None:
            kcls[0, :N] = s.kcls
        # fault operands: only faulty epochs carry them; pad lanes stay
        # clean, their inf attempt times hide them regardless
        fault_kw = {}
        if s.dies_at is not None:
            fault_kw["dies_at"] = np.asarray(s.dies_at, np.float64)[None]
        if s.clock_stamp_off is not None:
            stamp_off = np.zeros((1, n_pad))
            stamp_off[0, :N] = s.clock_stamp_off
            arr_off = np.zeros((1, n_pad, R))
            arr_off[0, :N] = s.clock_arr_off
            fault_kw["stamp_off"] = stamp_off
            fault_kw["arr_off"] = arr_off
        if s.pair_drop is not None:
            pair_drop = np.zeros((1, n_pad, R), dtype=bool)
            pair_drop[0, :N] = s.pair_drop
            pair_delay = np.zeros((1, n_pad, R))
            pair_delay[0, :N] = s.pair_delay
            fault_kw["pair_drop"] = pair_drop
            fault_kw["pair_delay"] = pair_delay
        if s.pre_deadline is not None:
            # pre-stamped multi-op deadlines: pad lanes carry the 0.0
            # sentinel (= stamp normally)
            pre_dl = np.zeros((1, n_pad))
            pre_dl[0, :N] = s.pre_deadline
            fault_kw["pre_dl"] = pre_dl
        if s.sync_theta is not None:
            # a modeled sync round: [M, M] probe arrays, no padding
            fault_kw["sync_theta"] = s.sync_theta
            fault_kw["sync_rtt"] = s.sync_rtt
            fault_kw["sync_safety"] = float(cfg.clock.sigma_safety)
            fault_kw["sync_floor"] = float(cfg.clock.sigma_floor)
        pulled = eng.step(pool[None], np.asarray(ptr)[None],
                          np.asarray(cnt)[None], t, c2p, owd,
                          drop, reply, np.asarray(s.alive, bool)[None], kcls,
                          [s.leader], [N], use_kcls=s.kcls is not None,
                          release_floor=[s.release_floor], **fault_kw)
        (s.stamp, s.deadlines, s.arrivals, s.admitted, s.release,
         s.commit_time, s.fast, s.committed, s.exec_order) = \
            [o[0, :N] for o in pulled[:9]]
        if s.sync_theta is not None:
            # the round's estimator outputs fold at the epoch boundary
            s.sync_est, s.sync_sigma = pulled[9], pulled[10]
            eng.clocksync.consume_round(s.sync_est, s.sync_sigma)
        s.reply_owd = rep


class DeliverStage(Stage):
    """Reply delivery at the client + latency accounting.

    ``committed`` stays the protocol-level verdict (the entry is in the
    replicated log); ``delivered`` additionally requires the reply to reach
    the client -- a committed-but-undelivered request is retried by the
    client and answered from the at-most-once replay cache (LogStage skips
    re-appending it)."""

    name = "deliver"

    def run(self, s, eng):
        with spans.span("deliver_log"):
            s.commit_at_client = s.commit_time + s.p2c
            # Latency is measured from the ORIGINAL submission (t0): a
            # retried request's earlier timed-out attempts are part of its
            # latency.
            lat = s.commit_at_client - s.t0
            lat[~s.committed] = np.inf
            s.latency = lat
            s.delivered = s.committed & np.isfinite(lat)


class LogStage(Stage):
    """Cross-epoch replica-log bookkeeping (the recovery pipeline's input).

    Appends the epoch's committed entries -- in the kernel's deadline execution
    order -- to the shared synced log, advances every live replica's
    sync-point (the steady-state log-modification flow: by epoch end each
    live replica has synced the leader's log), and files uncommitted-but-
    admitted entries as per-replica speculative tails, which is exactly the
    state MERGE-LOG consults at the next view change."""

    name = "log"

    def run(self, s, eng):
        with spans.span("deliver_log"):
            eng.logs.observe_epoch(
                s, reachable=(~eng.unreachable if eng.unreachable.any()
                              else None))


# The stages `DomEngine` runs, in order (the reference's fused pipeline;
# its staged numpy stamp/dom/commit stages are a seam of `repro`).
FUSED_STAGES = (SampleStage, FusedEpochStage, DeliverStage, LogStage)


def _partition_percentile(a: np.ndarray, q: float) -> float:
    """np.percentile(a, q) (linear interpolation) via O(n) np.partition.

    Only two order statistics are consumed, so selecting them beats the
    full sort np.percentile does; the interpolation mirrors numpy's _lerp
    (including the monotonicity-preserving form switch at t >= 0.5) so the
    value is bit-identical.
    """
    pos = q / 100.0 * (a.size - 1)
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    part = np.partition(a, [lo, hi])
    lo_v, hi_v = float(part[lo]), float(part[hi])
    t = pos - lo
    if t == 0.0 or lo_v == hi_v:
        return lo_v
    if t < 0.5:
        return lo_v + t * (hi_v - lo_v)
    return hi_v - (hi_v - lo_v) * (1.0 - t)


class ReplicaLogState:
    """Array-structured per-replica logs for the recovery pipeline (SA).

    The epoch approximation keeps ONE shared synced log -- the committed
    entries, in execution order, each stamped with the view and batch that
    committed it -- plus per-replica scalars (`sync_point`,
    `last_normal_view`) and per-replica speculative tails: uncommitted
    entries encoded as columns + an admitted-mask over replicas. That is
    exactly the state Alg 4's MERGE-LOG consults, so a view change is one
    call into `repro_torch.core.recovery.merge_logs_vectorized` (last-normal-view
    filter -> sync-point prefix copy -> ceil(f/2)+1 majority beyond it ->
    key3 re-sort) instead of per-replica Python loops.

    Modeling notes: within an epoch every live replica syncs the leader's
    log by epoch end (the steady-state log-modification flow), so live
    sync-points advance together; a crashed replica loses its in-memory
    state (speculative column cleared, sync-point zeroed, last-normal-view
    -1 = RECOVERING) and a relaunched one completes state transfer during
    its first live epoch (sync-point/last-normal-view catch up then).
    """

    LOG_COLS = ("deadline", "cid", "rid", "kcls", "view", "batch", "recovered")

    def __init__(self, n_replicas: int, f: int):
        self.n = n_replicas
        self.f = f
        self.view = 0
        self.sync_point = np.zeros(n_replicas, np.int64)
        self.last_normal_view = np.zeros(n_replicas, np.int64)
        self.synced_len = 0
        self.tail_deadline = -np.inf        # deadline of the last synced entry
        self._chunks: dict[str, list[np.ndarray]] = {c: [] for c in self.LOG_COLS}
        # speculative tails: entries admitted somewhere but not committed
        self.spec_deadline = np.empty(0)
        self.spec_cid = np.empty(0, np.int64)
        self.spec_rid = np.empty(0, np.int64)
        self.spec_kcls = np.empty(0, np.int64)
        self.spec_admitted = np.empty((0, n_replicas), bool)
        # committed-but-undelivered uids: the client retries these and the
        # replicas answer from the at-most-once replay cache -- the replay
        # commit must not re-enter the log
        self._replay_uids = np.empty(0, np.int64)
        self._batch = 0
        # LossyAcker (Byzantine-leaning) durability model: a lossy replica
        # keeps ACKING normally -- its sync_point advances and quorums count
        # it -- but its durable persistence freezes at `persist_point`. A
        # crash exposes the gap: the acked-but-unpersisted suffix becomes a
        # durability event and a hole in that replica's durable-log view.
        self.lossy = np.zeros(n_replicas, bool)
        self.persist_point = np.zeros(n_replicas, np.int64)
        self.durability_events: list[dict] = []
        self._holes: dict[int, list[tuple[int, int]]] = {}

    # -- log append (per epoch batch) ---------------------------------------
    def observe_epoch(self, s: "EpochState",
                      reachable: Optional[np.ndarray] = None) -> None:
        batch = self._batch
        self._batch += 1
        committed = np.asarray(s.committed, bool)
        order = np.asarray(s.exec_order, np.int64)
        row_uids = pack_uids(s.cid, s.rid)
        exec_idx = order[committed[order]]          # committed, in exec order
        uids = row_uids[exec_idx]
        if self._replay_uids.size:
            replay = np.isin(uids, self._replay_uids)
            if replay.any():
                # replays that finally reached their client stop retrying
                done = uids[replay][np.asarray(s.delivered, bool)[exec_idx[replay]]]
                self._replay_uids = self._replay_uids[
                    ~np.isin(self._replay_uids, done)]
                exec_idx = exec_idx[~replay]
                uids = uids[~replay]
        if exec_idx.size:
            kcls = (s.kcls[exec_idx] if s.kcls is not None
                    else np.full(exec_idx.size, -1, np.int64))
            self._append(s.deadlines[exec_idx], s.cid[exec_idx],
                         s.rid[exec_idx], kcls, batch=batch)
            undelivered = ~np.asarray(s.delivered, bool)[exec_idx]
            if undelivered.any():
                self._replay_uids = np.concatenate(
                    [self._replay_uids, uids[undelivered]])
        # Partitioned-away (unreachable) replicas receive no log
        # modifications: their sync/persist points freeze for the window,
        # which is exactly the asymmetry check_partition_liveness measures.
        sync = (np.asarray(s.alive, bool) if reachable is None
                else np.asarray(s.alive, bool) & reachable)
        self.sync_point[sync] = self.synced_len
        self.last_normal_view[sync] = self.view
        self.persist_point[sync & ~self.lossy] = self.synced_len
        # speculative tails: uncommitted entries some live replica admitted.
        # A failed RETRY of an already-durable uid (committed earlier, reply
        # lost) must NOT re-enter them -- the entry is in the synced log and
        # the oracle's synced-uid membership check would skip it; without
        # this exclusion a view change could append the uid a second time.
        spec = ~committed & np.asarray(s.admitted, bool).any(axis=1)
        if spec.any() and self._replay_uids.size:
            spec &= ~np.isin(row_uids, self._replay_uids)
        if self.spec_deadline.size:
            # an entry leaves the speculative tails when a newer attempt
            # lands (replace) or when it commits (now durable)
            gone = row_uids[spec | committed]
            self._drop_spec(np.isin(
                pack_uids(self.spec_cid, self.spec_rid), gone))
        if spec.any():
            self.spec_deadline = np.concatenate(
                [self.spec_deadline, s.deadlines[spec]])
            self.spec_cid = np.concatenate([self.spec_cid, s.cid[spec]])
            self.spec_rid = np.concatenate([self.spec_rid, s.rid[spec]])
            kcls = (s.kcls[spec] if s.kcls is not None
                    else np.full(int(spec.sum()), -1, np.int64))
            self.spec_kcls = np.concatenate([self.spec_kcls, kcls])
            self.spec_admitted = np.concatenate(
                [self.spec_admitted, np.asarray(s.admitted, bool)[spec]])

    def _append(self, deadline, cid, rid, kcls, batch: int,
                view: Optional[int] = None, recovered: bool = False) -> None:
        k = len(deadline)
        self._chunks["deadline"].append(np.asarray(deadline, np.float64))
        self._chunks["cid"].append(np.asarray(cid, np.int64))
        self._chunks["rid"].append(np.asarray(rid, np.int64))
        self._chunks["kcls"].append(np.asarray(kcls, np.int64))
        self._chunks["view"].append(
            np.full(k, self.view if view is None else view, np.int64))
        self._chunks["batch"].append(np.full(k, batch, np.int64))
        self._chunks["recovered"].append(np.full(k, recovered, bool))
        self.synced_len += k
        if k:
            self.tail_deadline = float(np.asarray(deadline)[-1])

    def _drop_spec(self, mask: np.ndarray) -> None:
        if mask.any():
            keep = ~mask
            self.spec_deadline = self.spec_deadline[keep]
            self.spec_cid = self.spec_cid[keep]
            self.spec_rid = self.spec_rid[keep]
            self.spec_kcls = self.spec_kcls[keep]
            self.spec_admitted = self.spec_admitted[keep]

    def drop_uids(self, cid: np.ndarray, rid: np.ndarray) -> None:
        """Forget speculative entries of abandoned requests (retry cap)."""
        if self.spec_deadline.size:
            gone = pack_uids(cid, rid)
            self._drop_spec(np.isin(
                pack_uids(self.spec_cid, self.spec_rid), gone))

    # -- fault hooks ---------------------------------------------------------
    def set_lossy(self, rid: int) -> None:
        """LossyAcker: from now on replica ``rid`` acks without persisting
        -- its persist point freezes where it stands."""
        self.lossy[rid] = True
        self.persist_point[rid] = self.sync_point[rid]

    def on_crash(self, rid: int) -> None:
        """Diskless crash: the replica's in-memory log state is gone."""
        if self.lossy[rid]:
            # The crash exposes the LossyAcker lie: everything it acked
            # past its frozen persist point was never durable. Record the
            # event (check_durability's evidence) and the hole range its
            # durable-log view excises (check_split_brain's evidence).
            acked = int(self.sync_point[rid])
            persisted = int(self.persist_point[rid])
            if acked > persisted:
                cols = self.log_columns()
                uids = pack_uids(cols["cid"][persisted:acked],
                                 cols["rid"][persisted:acked])
                self.durability_events.append({
                    "replica": rid, "acked": acked, "persisted": persisted,
                    "missing": acked - persisted, "uids": uids})
                self._holes.setdefault(rid, []).append((persisted, acked))
        if self.spec_admitted.size:
            self.spec_admitted[:, rid] = False
        self.sync_point[rid] = 0
        self.persist_point[rid] = 0
        self.last_normal_view[rid] = -1     # RECOVERING until a live epoch

    # -- the view change itself ----------------------------------------------
    def view_change(self, new_view: int, alive: np.ndarray) -> dict:
        """Run the vectorized MERGE-LOG; enter ``new_view``.

        Returns the recovery outcome: ``recovered`` -- column dict of the
        speculative entries the merge kept (appended to the synced log in
        key3 order, stamped recovered); ``dropped`` -- column dict of the
        rest (sub-majority or behind the authoritative prefix; the proxies
        re-admit them into the next epoch's DOM stage).
        """
        alive = np.asarray(alive, bool)
        qualified = qualified_replicas(self.last_normal_view, alive)
        merge_order, keep = merge_logs_vectorized(
            self.spec_deadline, self.spec_cid, self.spec_rid,
            self.spec_admitted, qualified, self.f,
            synced_tail_deadline=self.tail_deadline)
        out = {
            "recovered": {
                "deadline": self.spec_deadline[merge_order],
                "cid": self.spec_cid[merge_order],
                "rid": self.spec_rid[merge_order],
                "kcls": self.spec_kcls[merge_order],
            },
            "dropped": {
                "deadline": self.spec_deadline[~keep],
                "cid": self.spec_cid[~keep],
                "rid": self.spec_rid[~keep],
            },
        }
        batch = self._batch
        self._batch += 1
        rec = out["recovered"]
        if merge_order.size:
            self._append(rec["deadline"], rec["cid"], rec["rid"], rec["kcls"],
                         batch=batch, view=new_view, recovered=True)
        # every live replica installs the merged log via StartView
        self.view = new_view
        self.sync_point[alive] = self.synced_len
        self.last_normal_view[alive] = new_view
        self.persist_point[alive & ~self.lossy] = self.synced_len
        self.spec_deadline = np.empty(0)
        self.spec_cid = np.empty(0, np.int64)
        self.spec_rid = np.empty(0, np.int64)
        self.spec_kcls = np.empty(0, np.int64)
        self.spec_admitted = np.empty((0, self.n), bool)
        return out

    # -- trace export --------------------------------------------------------
    def log_columns(self) -> dict[str, np.ndarray]:
        """The synced log as one column dict (concatenated lazily)."""
        dtypes = dict(deadline=np.float64, cid=np.int64, rid=np.int64,
                      kcls=np.int64, view=np.int64, batch=np.int64,
                      recovered=bool)
        return {c: (np.concatenate(ch) if ch else np.empty(0, dtypes[c]))
                for c, ch in self._chunks.items()}

    @property
    def has_holes(self) -> bool:
        return bool(self._holes)

    def replica_log_columns(self) -> dict[int, dict[str, np.ndarray]]:
        """Per-replica durable-log views: the shared synced log minus each
        replica's recorded durability holes. Identical views everywhere in
        honest runs; a LossyAcker's excised hole shifts its suffix, which is
        the positional divergence check_split_brain detects."""
        full = self.log_columns()
        out: dict[int, dict[str, np.ndarray]] = {}
        for r in range(self.n):
            holes = self._holes.get(r)
            if not holes:
                out[r] = full
                continue
            keep = np.ones(self.synced_len, bool)
            for lo, hi in holes:
                keep[lo:hi] = False
            out[r] = {c: v[keep] for c, v in full.items()}
        return out


class DomEngine:
    """Runs the fused DOM data plane, one epoch batch (or K-epoch window)
    at a time, on ``cfg.device``.

    The engine owns the stage list, the device the body runs on, and the
    cross-epoch replica-log state feeding the recovery pipeline
    (`ReplicaLogState`); the cluster owns time, the pending buffer, fault
    events, view changes, and result accumulation.
    """

    def __init__(self, cfg, net, n_replicas: int):
        self.cfg = cfg
        self.net = net
        self.n = n_replicas
        self.device = resolve_device(getattr(cfg, "device", "cuda"))
        # the runtime invariant sanitizer, on either switch (None: off)
        self.sanitizer: Optional[Sanitizer] = None
        if getattr(cfg, "sanitize", False) \
                or os.environ.get("REPRO_SANITIZE", "") not in ("", "0"):
            self.sanitizer = Sanitizer(self.tier_name)
        self.logs = ReplicaLogState(n_replicas, cfg.f)
        self.stages = [stage() for stage in FUSED_STAGES]
        self._bodies: dict = {}
        self.owd_pool = np.zeros(0)     # sliding OWD sample pool (host mirror)
        self._bound_cache: Optional[float] = None
        # Clock-fault state (scenario `ClockFault`/`ClockClear` events): per
        # node, the (mu, sigma) of the N(mu, sigma) error added to every
        # clock read. Separate rng stream so fault-free runs are untouched.
        self.replica_clock = np.zeros((n_replicas, 2))
        self.proxy_clock = np.zeros((getattr(cfg, "n_proxies", 1), 2))
        self.rng = np.random.default_rng(getattr(cfg, "seed", 0) + 0xC10C)
        # Per-pair network-fault state (Partition / GrayLink scenario
        # events), [P, R] over (proxy, replica) pairs and lazily allocated:
        # None means no pair fault has ever been active, so SampleStage
        # draws exactly the fault-free variates. `unreachable` marks the
        # partition minority: frozen sync/persist points, non-viable leaders.
        self._pair_block: Optional[np.ndarray] = None       # [P, R] bool
        self._pair_gray_drop: Optional[np.ndarray] = None   # [P, R] drop prob
        self._pair_mu: Optional[np.ndarray] = None          # [P, R] delay mean
        self._pair_sigma: Optional[np.ndarray] = None       # [P, R] delay sigma
        self.unreachable = np.zeros(n_replicas, bool)
        # SkewedStamper (Byzantine-leaning): per-proxy deterministic stamp
        # bias, folded into the clock stamp_off operand by SampleStage.
        self.proxy_stamp_bias = np.zeros(getattr(cfg, "n_proxies", 1))
        # Modeled clock-sync loop: regimes with ``cfg.clock.sync_model``
        # attach a fleet daemon that owns clock TRUTH and the MEASURED error
        # bounds; DOM's beta-margin then comes from measurements.
        self.clocksync = None
        if getattr(getattr(cfg, "clock", None), "sync_model", False):
            self.clocksync = ClockSyncDaemon(
                n_replicas, getattr(cfg, "n_proxies", 1), cfg.clock, net,
                seed=getattr(cfg, "seed", 0))
        self._margin_used: Optional[float] = None

    @property
    def tier_name(self) -> str:
        """The port's compute tier: the DOM kernels on the card, or their
        plain versions on the CPU."""
        return f"torch-{self.device.type}"

    @property
    def clocks_faulty(self) -> bool:
        return bool(self.replica_clock.any() or self.proxy_clock.any())

    def set_clock_fault(self, role: str, idx: int, mu: float,
                        sigma: float) -> None:
        """Install N(mu, sigma) read error on one node's clock (0, 0 clears).

        ``role`` is "replica" or "proxy"; proxy indices wrap like
        `NezhaCluster.clock_of_proxy` does (non-proxy mode reuses the
        proxy-slot clocks)."""
        if role == "replica":
            if not (0 <= idx < self.n):
                raise ValueError(f"replica id {idx} out of range [0, {self.n})")
            self.replica_clock[idx] = (mu, sigma)
        elif role == "proxy":
            self.proxy_clock[idx % len(self.proxy_clock)] = (mu, sigma)
        else:
            raise ValueError(f"unknown clock role {role!r}")

    # -- per-pair network faults (Partition / GrayLink / SkewedStamper) ------
    @property
    def pairs_faulty(self) -> bool:
        """Any pair-fault state allocated: epochs carry pair operands and
        fall off the K-epoch window fast path (mirrors `clocks_faulty`)."""
        return self._pair_block is not None

    @property
    def gray_active(self) -> bool:
        return self._pair_gray_drop is not None and bool(
            self._pair_gray_drop.any() or self._pair_mu.any()
            or self._pair_sigma.any())

    @property
    def stampers_biased(self) -> bool:
        return bool(self.proxy_stamp_bias.any())

    # -- modeled clock sync --------------------------------------------------
    @property
    def sync_active(self) -> bool:
        """A modeled sync daemon is attached: every epoch carries the
        fleet's effective residual offsets (and round epochs the probe
        operands), so sync regimes fall off the K-epoch window fast path exactly
        like injected clock faults do."""
        return self.clocksync is not None

    def advance_sync(self, t_end: float) -> None:
        """Advance the daemon's clock truth to the epoch boundary ``t_end``
        and queue any due probe round; no-op without a daemon. The cluster
        calls this once per epoch BEFORE running it."""
        if self.clocksync is not None:
            self.clocksync.advance(float(t_end))

    def _ensure_pair_state(self) -> None:
        if self._pair_block is None:
            P = len(self.proxy_stamp_bias)
            self._pair_block = np.zeros((P, self.n), bool)
            self._pair_gray_drop = np.zeros((P, self.n))
            self._pair_mu = np.zeros((P, self.n))
            self._pair_sigma = np.zeros((P, self.n))

    def _maybe_release_pair_state(self) -> None:
        # Drop back to None once every pair fault has cleared: later epochs
        # return to the exact fault-free draw sequence AND the window path.
        if self._pair_block is not None and not (
                self._pair_block.any() or self._pair_gray_drop.any()
                or self._pair_mu.any() or self._pair_sigma.any()):
            self._pair_block = None
            self._pair_gray_drop = None
            self._pair_mu = None
            self._pair_sigma = None

    def set_partition(self, minority) -> None:
        """Cut the minority replicas off: no proxy reaches them, their
        replies never arrive, and their sync/persist points freeze (the
        cluster additionally rules them out as viable leaders)."""
        self._ensure_pair_state()
        minority = np.asarray(list(minority), np.int64)
        self.unreachable[:] = False
        self.unreachable[minority] = True
        self._pair_block[:, :] = False
        self._pair_block[:, minority] = True

    def clear_partition(self) -> None:
        self.unreachable[:] = False
        if self._pair_block is not None:
            self._pair_block[:, :] = False
            self._maybe_release_pair_state()

    def set_gray(self, proxy_ids, replica_ids, delay_mu: float,
                 delay_sigma: float, drop_prob: float) -> None:
        """Install a gray failure on the given (proxy, replica) pairs, both
        directions: extra N(mu, sigma)+ path delay and/or extra drops."""
        self._ensure_pair_state()
        ix = np.ix_(np.asarray(list(proxy_ids), np.int64),
                    np.asarray(list(replica_ids), np.int64))
        self._pair_mu[ix] = delay_mu
        self._pair_sigma[ix] = delay_sigma
        self._pair_gray_drop[ix] = drop_prob

    def clear_gray(self, proxy_ids, replica_ids) -> None:
        if self._pair_block is None:
            return
        ix = np.ix_(np.asarray(list(proxy_ids), np.int64),
                    np.asarray(list(replica_ids), np.int64))
        self._pair_mu[ix] = 0.0
        self._pair_sigma[ix] = 0.0
        self._pair_gray_drop[ix] = 0.0
        self._maybe_release_pair_state()

    def set_stamp_bias(self, proxy_id: int, bias: float) -> None:
        """SkewedStamper: proxy ``proxy_id`` stamps deadlines shifted by
        ``bias`` seconds (0 restores honesty). Indices wrap like
        `set_clock_fault` proxy slots do."""
        self.proxy_stamp_bias[proxy_id % len(self.proxy_stamp_bias)] = bias

    def observed_owd_samples(self, s: "EpochState") -> np.ndarray:
        """The OWD samples the proxies' estimators would OBSERVE: recv local
        read minus send local read, i.e. true OWD perturbed by both ends'
        clock errors. Faulty clocks poison the DOM bound pool exactly as the
        event backend's sliding-window estimator is poisoned (negative /
        inflated estimates fall back to the clamp, S4). Per-pair gray delay
        (GrayLink) joins the observed path first, for the same reason: a
        slow-but-alive link inflates the bound the proxies stamp with."""
        owd = s.owd_pr if s.pair_delay is None else s.owd_pr + s.pair_delay
        if s.clock_arr_off is None and s.clock_stamp_off is None:
            return owd
        return owd + s.clock_arr_off - s.clock_stamp_off[:, None]

    def device_pool_state(self) -> tuple[np.ndarray, np.int64, np.int64]:
        """(pool, ptr, cnt) ring-buffer operands mirroring `owd_pool`.

        The ring's live multiset equals the host sliding pool exactly; +inf
        fills the unfilled tail so the device sort-select sees the live
        samples first. Uploaded per dispatch -- a host->device transfer,
        not a synchronizing pull (the fold itself runs in the body).
        """
        W = self.cfg.dom.window * self.n
        pool = np.full(W, np.inf)
        L = self.owd_pool.size
        pool[:L] = self.owd_pool
        return pool, np.int64(L % W), np.int64(L)

    def load_pool_state(self, pool: np.ndarray, ptr, cnt) -> None:
        """Install a (pool, ptr, cnt) ring -- e.g. what the reference
        engine's `device_pool_state()` returns -- as the host sliding pool.
        The ring's live samples, oldest first, become `owd_pool`."""
        pool = np.asarray(pool, np.float64)
        W = self.cfg.dom.window * self.n
        if pool.shape != (W,):
            raise ValueError(f"pool has shape {pool.shape}, expected ({W},)")
        ptr, cnt = int(ptr), int(cnt)
        oldest = (ptr - cnt) % W
        self.owd_pool = np.roll(pool, -oldest)[:cnt]
        self._bound_cache = None

    def bound_margin(self) -> float:
        """The clock-error margin added to the OWD percentile (one float64
        operand; host and device add the identical value).

        With a modeled sync daemon the margin is beta * (sigma_S + sigma_R)
        over the daemon's MEASURED per-node bounds at the current epoch
        boundary -- the paper's Eq. (1) fed by the estimator instead of by
        configuration, so degraded sync widens the stamped deadlines and
        recovered sync narrows them back. Without one, the legacy
        configured-residual margin is unchanged bit-for-bit."""
        if self.clocksync is not None:
            sig_s, sig_r = self.clocksync.margin_sigmas()
            return self.cfg.dom.beta * (sig_s + sig_r)
        return self.cfg.dom.beta * 2.0 * self.cfg.clock.residual_sigma

    def update_bound(self, owd_new: np.ndarray) -> float:
        """Fold new OWD samples into the sliding pool; return the DOM bound.

        The percentile is recomputed only when the pool actually changed
        (partition-based selection, O(pool)); an unchanged pool reuses the
        cached bound.
        """
        cfg = self.cfg
        margin = self.bound_margin()
        if margin != self._margin_used:
            # measured-margin drift (a sync round landed, or the reported
            # bound grew through an outage): the cached percentile+margin
            # value is stale even when the pool itself is unchanged
            self._margin_used = margin
            self._bound_cache = None
        new = np.ravel(owd_new)
        if new.size:
            pool = np.concatenate([self.owd_pool, new])
            self.owd_pool = pool[-cfg.dom.window * self.n:]
            self._bound_cache = None
        if self._bound_cache is None:
            if self.owd_pool.size == 0:
                bound = cfg.dom.clamp_d
            else:
                bound = _partition_percentile(self.owd_pool,
                                              cfg.dom.percentile) + margin
                if not (0.0 < bound < cfg.dom.clamp_d):
                    bound = cfg.dom.clamp_d
            self._bound_cache = float(bound)
        return self._bound_cache

    # -- node-id layout (single source; the cluster sizes the network from it)
    def proxy_nodes(self, proxy_ids):
        return self.n + proxy_ids

    def client_nodes(self, client_ids):
        return self.n + self.cfg.n_proxies + client_ids

    def run_epoch(self, due: np.ndarray, alive: np.ndarray, leader: int,
                  release_floor: float = 0.0,
                  dies_at: Optional[np.ndarray] = None) -> EpochState:
        """Push one structured batch (PENDING_DTYPE) through every stage."""
        s = EpochState(
            t=np.ascontiguousarray(due["t"]),
            t0=np.ascontiguousarray(due["t0"]),
            cid=np.ascontiguousarray(due["cid"]),
            rid=np.ascontiguousarray(due["rid"]),
            kcls=(np.ascontiguousarray(due["kcls"])
                  if getattr(self.cfg, "commutative", False) else None),
            alive=np.asarray(alive, bool),
            leader=int(leader),
            release_floor=float(release_floor),
            dies_at=dies_at,
        )
        dl = np.ascontiguousarray(due["dl"])
        if (dl > 0).any():
            # only multi-op-carrying epochs pay the pre_dl operand
            s.pre_deadline = dl
        for stage in self.stages:
            stage.run(s, self)
        if self.clocksync is not None and self.clocksync.pending is not None:
            # a due round that rode no dispatch lands via the numpy twin
            self.clocksync.apply_pending()
        if self.sanitizer is not None:
            self.sanitizer.check_epoch(s, self)
        return s

    # -- the device program ----------------------------------------------------
    def _body(self, use_kcls: bool, use_cap: bool):
        key = (use_kcls, use_cap)
        if key not in self._bodies:
            self._bodies[key] = _build_epoch_body(self.cfg.f, use_kcls,
                                                  use_cap)
        return self._bodies[key]

    def _scalars(self) -> dict:
        """The per-dispatch host scalars of the body (float64 values),
        shared by every group of a batched call."""
        cfg = self.cfg
        return dict(pq01=float(cfg.dom.percentile) / 100.0,
                    margin=self.bound_margin(),
                    clamp_d=float(cfg.dom.clamp_d),
                    batch_delay=float(cfg.leader_batch_delay),
                    cap=float(getattr(cfg, "deadline_cap", 0.0) or 0.0))

    def _upload(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def step(self, pool, ptr, cnt, t, c2p, owd, drop, reply, alive, kcls,
             leader, n_valid, *, use_kcls: bool, release_floor,
             **fault_kw) -> list[np.ndarray]:
        """One epoch of G groups through the body on the device: numpy
        operands with a leading G axis up (``leader``, ``n_valid`` and
        ``release_floor`` one value a group), the outputs (see
        `_build_epoch_body`) back as numpy in one transfer."""
        sc = self._scalars()
        body = self._body(use_kcls, sc["cap"] > 0.0)
        spans.body_dispatch(n_valid, t.shape[-1])
        up = self._upload
        kw = {k: (up(v) if isinstance(v, np.ndarray) else v)
              for k, v in fault_kw.items()}
        _, outs, _ = body(up(pool), up(ptr), up(cnt), up(t), up(c2p),
                          up(owd), up(drop), up(reply),
                          up(np.asarray(alive, bool)), up(kcls), leader,
                          n_valid, **sc, floor=release_floor, **kw)
        return _pull(outs)

    def run_window(self, dues, alive: np.ndarray, leader: int,
                   release_floor: float = 0.0) -> list:
        """Run a window of fault-free epochs with ONE device -> host pull.

        ``dues`` is a sequence of PENDING_DTYPE batches, one per epoch in
        epoch order; its length should be a `SCAN_K_BUCKETS` value (callers
        pad with empty batches, which yield None).

        Preconditions -- the cluster's fast-path guards own them: synced
        clocks, no crash inside the window (``dies_at`` is never carried),
        and alive/leader/release_floor constant across it. Host-side
        sampling, delivery, and log bookkeeping still run per epoch IN ORDER
        (identical rng streams), so the returned EpochStates are bit-for-bit
        identical to sequential `run_epoch` calls; the body runs once per
        epoch on the device with the (pool, ptr, cnt) ring carry kept there.
        """
        if self.clocks_faulty or self.pairs_faulty or self.stampers_biased \
                or self.sync_active \
                or any(d.size and (d["dl"] > 0).any() for d in dues):
            # (pre-stamped multi-op deadlines need the per-epoch pre_dl
            # operand; the window never carries it)
            return [self.run_epoch(d, alive, leader, release_floor)
                    if d.size else None for d in dues]
        sample, _, deliver, log = self.stages
        cfg = self.cfg
        alive = np.asarray(alive, bool)
        commutative = bool(getattr(cfg, "commutative", False))
        K = len(dues)
        states: list = [None] * K
        for i, due in enumerate(dues):
            if due.size == 0:
                continue
            s = EpochState(
                t=np.ascontiguousarray(due["t"]),
                t0=np.ascontiguousarray(due["t0"]),
                cid=np.ascontiguousarray(due["cid"]),
                rid=np.ascontiguousarray(due["rid"]),
                kcls=(np.ascontiguousarray(due["kcls"])
                      if commutative else None),
                alive=alive,
                leader=int(leader),
                release_floor=float(release_floor),
            )
            sample.run(s, self)
            states[i] = s
        live = [i for i, s in enumerate(states) if s is not None]
        if not live:
            return states
        with spans.span("dispatch", device=True):
            self._window_dispatch(states, live, alive, leader, release_floor,
                                  commutative)
        for i in live:
            s = states[i]
            deliver.run(s, self)
            log.run(s, self)
            if self.sanitizer is not None:
                self.sanitizer.check_epoch(s, self)
        return states

    def _window_dispatch(self, states, live, alive, leader, release_floor,
                         commutative) -> None:
        """The device half of a window: stacked operands up, the body once
        an epoch with requests (the ring carry kept on the device), the
        outputs back in one pull and into each epoch's state, and the host
        pool mirror advanced in epoch order (bit-identical to the device
        fold by construction)."""
        K = len(states)
        R = self.n
        n_pad = max(_pow2_bucket(states[i].t.size) for i in live)
        # Stacked [K, n_pad(, R)] operands, one shared bucket across the
        # window (pad lanes are invisible to real rows by construction).
        t = np.full((K, n_pad), np.inf)
        c2p = np.zeros((K, n_pad))
        owd = np.zeros((K, n_pad, R))
        drop = np.ones((K, n_pad, R), dtype=bool)
        reply = np.full((K, n_pad, R), np.inf)
        kcls = np.full((K, n_pad), -1, np.int64)
        for i in live:
            s = states[i]
            N = s.t.size
            t[i, :N] = s.t
            c2p[i, :N] = s.c2p
            owd[i, :N] = s.owd_pr
            drop[i, :N] = s.drop_pr
            reply[i, :N] = s.reply_owd
            if s.kcls is not None:
                kcls[i, :N] = s.kcls
        sc = self._scalars()
        body = self._body(commutative, sc["cap"] > 0.0)
        up = self._upload
        t_d, c2p_d, owd_d, drop_d, reply_d, kcls_d, alive_d = (
            up(t), up(c2p), up(owd), up(drop), up(reply), up(kcls),
            up(alive[None]))
        pool, ptr, cnt = (up(np.asarray(x)[None])
                          for x in self.device_pool_state())
        outs = []
        for i in live:
            # one group: each epoch's operands keep a leading axis of 1
            (pool, ptr, cnt), out, _ = body(
                pool, ptr, cnt, t_d[i:i + 1], c2p_d[i:i + 1],
                owd_d[i:i + 1], drop_d[i:i + 1], reply_d[i:i + 1], alive_d,
                kcls_d[i:i + 1], [leader], [states[i].t.size], **sc,
                floor=[release_floor])
            outs.append(out)
            spans.body_dispatch((states[i].t.size,), n_pad)
        ys = _pull([torch.cat(col) for col in zip(*outs)])
        for j, i in enumerate(live):
            s = states[i]
            N = s.t.size
            (s.stamp, s.deadlines, s.arrivals, s.admitted, s.release,
             s.commit_time, s.fast, s.committed, s.exec_order) = \
                [y[j][:N] for y in ys]
            # the host pool mirror advances in epoch order
            s.bound = self.update_bound(self.observed_owd_samples(s))
            rep = s.reply_owd.copy()
            rep[:, ~alive] = np.inf
            s.reply_owd = rep


__all__ = [
    "PENDING_DTYPE", "PendingBuffer", "SCAN_K_BUCKETS", "classify_commits",
    "classify_commits_device",
    "EpochState", "Stage", "SampleStage", "FusedEpochStage", "DeliverStage",
    "LogStage", "FUSED_STAGES", "ReplicaLogState", "DomEngine",
]
