"""Port of `repro/core/sharded.py`: multi-group sharded Nezha, G independent
consensus groups over one key space, on torch.

  groups     G fully independent `VectorizedNezhaCluster` instances -- own
             `CloudNetwork`, own `DomEngine` (own rng streams, seeded
             ``cfg.seed + g * group_seed_stride``), own leader/view/
             `ReplicaLogState`, own (pool, ptr, cnt) DOM-bound state.  A
             crash or partition in one group runs that group's recovery
             pipeline while every other group keeps committing.
  routing    deterministic key -> group assignment through the stable
             hashing seam (`repro_torch.sim.workload.route_keys`, built on
             `repro_torch.core.hashing.key_group_np`) -- never the builtin
             ``hash()``, so the assignment survives PYTHONHASHSEED changes
             and process restarts.
  MultiOp    a request whose keys span >= 2 groups.  The client layer
             pre-stamps ONE global deadline (``t + multiop_margin``) and
             submits one sub-entry per involved group carrying the
             identical (deadline, uid); every group sequences the op at the
             same global deadline slot -- atomic cross-group commit in
             global deadline order with no coordination round.  The op is
             client-committed when every involved group has committed its
             sub-entry (commit time = max over groups; fast iff every group
             took the fast path).  `repro_torch.sim.trace.
             check_cross_group_linearizability` validates exactly this.
  batched    with ``vmap_groups=True``, provably steady-state stretches
             (every group fault-free, synced clocks, no pre-stamped
             deadlines pending) run ALL groups' epochs through one call of
             the epoch body over a leading G axis -- one launch of each DOM
             kernel for all G groups, where the reference runs `jax.vmap`
             -- bit-for-bit identical to driving each group sequentially.

G = 1 degenerates to a single group fed the same seed, rid sequence and key
classes as ``nezha-vectorized``: summaries, latencies and commit traces are
bitwise identical by construction. The groups run on
``ShardedConfig.device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from repro_torch.core import spans
from repro_torch.core.cluster import Cluster, summarize_commits
from repro_torch.core.engine import (
    DeliverStage,
    EpochState,
    LogStage,
    SampleStage,
    _pow2_bucket,
)
from repro_torch.core.hashing import key_group
from repro_torch.core.quorum import leader_of_view
from repro_torch.core.recovery import pack_uids
from repro_torch.core.vectorized_cluster import (
    VectorizedConfig,
    VectorizedNezhaCluster,
)
from repro_torch.sim.workload import route_keys

_M64 = (1 << 64) - 1


@dataclass
class ShardedConfig(VectorizedConfig):
    """`VectorizedConfig` plus the sharding knobs."""

    groups: int = 1                 # G consensus groups over one key space
    group_seed_stride: int = 7919   # per-group seed = seed + g * stride
    #   (prime stride decorrelates group rng streams; g = 0 keeps cfg.seed,
    #   making G = 1 bitwise identical to the unsharded backend)
    multiop_margin: float = 2.5e-3  # pre-stamped deadline slack for cross-
    #   group ops: deadline = submit time + margin. A too-small margin only
    #   costs the fast path (DOM rejects late arrivals into the slow path),
    #   never atomicity or global order.
    vmap_groups: bool = False       # batch fault-free epochs of ALL groups
    #   through one call of the epoch body (leading G axis; one launch of
    #   each DOM kernel a generation); bit-identical to sequential
    #   per-group dispatch. The name is the reference's.


class ShardedNezhaCluster(Cluster):
    """G-group sharded Nezha behind the unified `Cluster` API.

    Replica ids are global: replica ``rid`` lives in group ``rid // n``
    (n = 2f + 1 per group). `schedule_fault` routes `GroupFault`-wrapped
    scenario events to their group; un-wrapped events hit group 0.
    """

    backend = "sharded"
    protocol = "nezha-sharded"
    supports_closed_loop = True     # per-instance: True only when G == 1

    def __init__(self, cfg: ShardedConfig, sm_factory=None):
        if cfg.groups < 1:
            raise ValueError(f"groups must be >= 1, got {cfg.groups}")
        self.cfg = cfg
        self.f = cfg.f
        self.G = int(cfg.groups)
        self.groups = [
            VectorizedNezhaCluster(self._group_config(g))
            for g in range(self.G)
        ]
        # One cache of epoch bodies across the groups: a body depends on
        # (f, use_kcls, use_cap) only, never on a seed.
        for grp in self.groups[1:]:
            grp.engine._bodies = self.groups[0].engine._bodies
        self.n = self.groups[0].n           # replicas PER GROUP
        self._now = 0.0
        self._next_rid = [0] * cfg.n_clients
        self._uids: list[int] = []          # packed uid per request
        self._t0s: list[float] = []         # submit time per request
        # packed uid -> {"groups": tuple, "deadline": float} for every
        # multi-key op spanning >= 2 groups (the cross-group checker's
        # ground truth: which groups must hold the op, at which slot)
        self._multi: dict[int, dict] = {}
        self._n_requests = 0
        self._on_commit = None
        self.supports_closed_loop = self.G == 1
        self.vmap_epochs = 0                # lockstep epochs run batched

    def _group_config(self, g: int) -> VectorizedConfig:
        return replace(self.cfg, seed=self.cfg.seed
                       + g * self.cfg.group_seed_stride)

    # -- Cluster API -------------------------------------------------------------
    @property
    def now(self) -> float:
        # G = 1 delegates: during a closed-loop `on_commit` flush the group
        # temporarily sets its _now to the commit's client-side time, and
        # the driver's resubmission must observe THAT clock (bit parity
        # with driving the group directly).
        return self.groups[0]._now if self.G == 1 else self._now

    @property
    def on_commit(self):
        return self._on_commit

    @on_commit.setter
    def on_commit(self, fn) -> None:
        self._on_commit = fn
        if fn is None:
            for grp in self.groups:
                grp.on_commit = None
        elif self.G == 1:
            self.groups[0].on_commit = fn
        else:
            raise NotImplementedError(
                "closed-loop callbacks need G == 1: a multi-group op has no "
                "single commit site to fire from; use mode='open'")

    def _route(self, keys: tuple) -> tuple:
        """The group of each key (`route_keys`; a single key through its
        scalar twin `hashing.key_group`, the same group)."""
        if not keys:
            # keyless requests share the global commutativity class; they
            # all route to group 0 (any fixed group preserves their total
            # order -- splitting them would break it)
            return (0,)
        if len(keys) == 1:
            return (key_group(keys[0], self.G),)
        return tuple(route_keys(np.asarray(keys, dtype=np.uint64),
                                self.G).tolist())

    def submit(self, client_id: int = 0, request_id: Optional[int] = None,
               keys: tuple = (), op=None, command=None) -> tuple[int, int]:
        return self.submit_at(self.now, client_id, keys=keys, op=op,
                              command=command)

    def submit_at(self, t: float, client_id: int = 0, keys: tuple = (),
                  op=None, command=None) -> tuple[int, int]:
        rid = self._next_rid[client_id]
        self._next_rid[client_id] = rid + 1
        # `pack_uids` in Python integers: (cid << 32 | rid) as an int64
        uid = ((int(client_id) << 32) | rid) & _M64
        uid -= (uid >> 63) << 64
        self._uids.append(uid)
        self._t0s.append(t)
        self._n_requests += 1
        ga = self._route(keys)
        gs = sorted(set(ga))
        if len(gs) == 1:
            self.groups[gs[0]].submit_at(
                t, client_id, keys=keys, op=op, command=command,
                request_id=rid)
        else:
            # MultiOp: ONE pre-stamped global deadline, one sub-entry per
            # involved group (same uid, same deadline) -- each group orders
            # it at the identical synchronized-time slot independently.
            dl = t + self.cfg.multiop_margin
            self._multi[uid] = {"groups": tuple(gs), "deadline": dl}
            for g in gs:
                sub = tuple(k for k, kg in zip(keys, ga) if kg == g)
                self.groups[g].submit_at(
                    t, client_id, keys=sub, op=op, command=command,
                    request_id=rid, deadline=dl)
        return (client_id, rid)

    def run_for(self, duration: float) -> None:
        horizon = self._now + duration
        if self.cfg.vmap_groups and self.G > 1 and self._batch_eligible():
            self._run_batched(horizon)
        else:
            for grp in self.groups:
                grp.run_for(duration)
        self._now = horizon

    # -- fault API (global replica ids; group g owns [g*n, (g+1)*n)) -------------
    def _split_rid(self, rid: int) -> tuple[int, int]:
        g, r = divmod(int(rid), self.n)
        if not (0 <= g < self.G):
            raise ValueError(
                f"replica id {rid} out of range [0, {self.G * self.n})")
        return g, r

    def crash(self, rid: int) -> None:
        g, r = self._split_rid(rid)
        self.groups[g].crash_at(self._now, r)

    def relaunch(self, rid: int) -> None:
        g, r = self._split_rid(rid)
        self.groups[g].relaunch_at(self._now, r)

    def schedule_fault(self, event) -> bool:
        if getattr(event, "kind", None) == "group-fault":
            if not (0 <= event.group < self.G):
                raise ValueError(
                    f"group {event.group} out of range [0, {self.G})")
            return self.groups[event.group].schedule_fault(event.event)
        # un-wrapped events target group 0 (scenario catalogs written for
        # single-group backends keep their meaning at G = 1)
        return self.groups[0].schedule_fault(event)

    # -- results -----------------------------------------------------------------
    @property
    def view_changes(self) -> int:
        return sum(grp.view_changes for grp in self.groups)

    def summary(self) -> dict:
        per_group_vc = [int(grp.view_changes) for grp in self.groups]
        extras = dict(
            batches=sum(g._batches for g in self.groups),
            epochs=sum(g._epochs for g in self.groups),
            tier=self.groups[0].engine.tier_name,
            view_changes=self.view_changes,
            recovered_entries=sum(g._recovered_entries for g in self.groups),
            dropped_speculative=sum(g._dropped_speculative
                                    for g in self.groups),
            partition_epochs=sum(g._partition_epochs for g in self.groups),
            gray_link_epochs=sum(g._gray_epochs for g in self.groups),
            groups=self.G,
            per_group_view_changes=per_group_vc,
            cross_group_ops=len(self._multi),
            vmap_epochs=self.vmap_epochs,
        )
        if self.G == 1:
            # delegate the numeric content wholesale: bitwise identical to
            # the unsharded backend (same seed, same rid/key-class streams)
            out = self.groups[0].summary()
            out.update(protocol=self.protocol, backend=self.backend,
                       **extras)
            return out
        lat, n_fast = self._merged_latencies()
        return summarize_commits(self.protocol, self.backend, lat,
                                 n_requests=self._n_requests, n_fast=n_fast,
                                 **extras)

    def _merged_latencies(self) -> tuple[np.ndarray, int]:
        """Client-observed commit latencies across all groups.

        Single-group ops: latency = commit-at-client - submit time, exactly
        the per-group `DeliverStage` value (recomputed bit-exactly from the
        commit trace).  Multi-group ops commit when the LAST involved group
        delivers (max over groups; fast iff all fast) and count once.
        Requests neither committed nor still pending in any group were
        abandoned (max_retries): one inf latency each, like the groups'
        own accounting.
        """
        recs = [r for g in self.groups for r in g._trace_commits]
        if recs:
            t_all = np.concatenate([np.asarray(r[0]) for r in recs])
            cid_all = np.concatenate([np.asarray(r[1]) for r in recs])
            rid_all = np.concatenate([np.asarray(r[2]) for r in recs])
            fast_all = np.concatenate([np.asarray(r[3]) for r in recs])
            uids = pack_uids(cid_all, rid_all)
        else:
            t_all = np.zeros(0)
            fast_all = np.zeros(0, bool)
            uids = np.zeros(0, np.int64)
        all_uids = np.asarray(self._uids, np.int64)
        all_t0 = np.asarray(self._t0s, np.float64)
        order = np.argsort(all_uids)
        su, st0 = all_uids[order], all_t0[order]

        def t0_of(u: np.ndarray) -> np.ndarray:
            return st0[np.searchsorted(su, u)]

        marr = np.asarray(sorted(self._multi), np.int64)
        mm = np.isin(uids, marr)
        parts: list[np.ndarray] = []
        n_fast = 0
        committed: list[np.ndarray] = []
        if (~mm).any():
            s_u, s_t, s_f = uids[~mm], t_all[~mm], fast_all[~mm]
            parts.append(s_t - t0_of(s_u))
            n_fast += int(s_f.sum())
            committed.append(s_u)
        if mm.any():
            m_u, m_t, m_f = uids[mm], t_all[mm], fast_all[mm]
            o = np.argsort(m_u, kind="stable")
            m_u, m_t, m_f = m_u[o], m_t[o], m_f[o]
            uniq, start = np.unique(m_u, return_index=True)
            counts = np.diff(np.append(start, m_u.size))
            expected = np.asarray(
                [len(self._multi[int(u)]["groups"]) for u in uniq])
            # atomic commit: delivered by EVERY involved group
            complete = counts == expected
            tmax = np.maximum.reduceat(m_t, start)
            allfast = np.minimum.reduceat(
                m_f.astype(np.int64), start).astype(bool)
            parts.append(tmax[complete] - t0_of(uniq[complete]))
            n_fast += int(allfast[complete].sum())
            committed.append(uniq[complete])
        committed_u = (np.concatenate(committed) if committed
                       else np.zeros(0, np.int64))
        pending = [grp._pending.uids() for grp in self.groups]
        pending_u = (np.concatenate(pending) if pending
                     else np.zeros(0, np.int64))
        gone = np.setdiff1d(all_uids,
                            np.union1d(committed_u, pending_u))
        if gone.size:
            parts.append(np.full(gone.size, np.inf))
        lat = np.concatenate(parts) if parts else np.zeros(0)
        return lat, n_fast

    # -- the batched group data plane --------------------------------------------
    def _batch_eligible(self) -> bool:
        """Every group provably steady-state: the batched call carries none
        of the optional fault operands (dies_at / clock offsets / pair
        faults / pre_dl), so any group needing one sends the whole
        dispatch down the bit-identical sequential path."""
        for grp in self.groups:
            eng = grp.engine
            if grp.on_commit is not None \
                    or grp._vc is not None or grp._fault_events \
                    or eng.clocks_faulty or eng.pairs_faulty \
                    or eng.stampers_biased or eng.sync_active \
                    or eng.unreachable.any() \
                    or not grp._alive.all() \
                    or grp._pending.has_prestamped():
                return False
        return True

    def _run_batched(self, horizon: float) -> None:
        """Lockstep epochs for all groups, the device work batched over a
        leading G axis.  Mirrors each group's own `run_for` exactly (epoch
        boundaries, host rng order, bookkeeping), so results are bit-for-
        bit identical to sequential per-group dispatch -- only the number
        of launches changes (one of each DOM kernel per epoch instead of
        G)."""
        ep = self.cfg.epoch_duration
        groups = self.groups
        now = groups[0]._now
        while now < horizon:
            epoch_end = min(horizon, now + ep)
            leaders = [leader_of_view(grp._view, grp.f) for grp in groups]
            dues = [grp._pending.pop_due(epoch_end) for grp in groups]
            active = [i for i, d in enumerate(dues) if d.size]
            if active:
                states = self._batched_epoch(groups, dues, leaders)
                for i in active:
                    groups[i]._absorb_epoch_state(dues[i], states[i])
                self.vmap_epochs += 1
                # further generations this epoch (client retries falling
                # due in-epoch): rare; per-group dispatch, same as the
                # sequential loop's while-pop_due
                for i in active:
                    grp = groups[i]
                    while True:
                        due = grp._pending.pop_due(epoch_end)
                        if due.size == 0:
                            break
                        s = grp.engine.run_epoch(due, grp._alive,
                                                 leaders[i],
                                                 grp._release_floor)
                        grp._absorb_epoch_state(due, s)
            for grp, ld in zip(groups, leaders):
                grp._last_leader = ld
                grp.epoch_leaders.append(ld)
                grp._epochs += 1
                grp._now = epoch_end
            now = epoch_end

    def _batched_epoch(self, groups, dues, leaders) -> list:
        """One epoch generation for ALL G groups as ONE call of the epoch
        body: per-group host sampling (each group's own rng streams, in
        group order), stacked pow2-padded operands, one body call (one
        launch of each DOM kernel) and one device -> host pull, then
        per-group Deliver/Log -- `FusedEpochStage.run` with a leading G
        axis.

        The leading axis is always the config-static G, NOT the number of
        groups with due work: an idle group rides as a zero-valid padding
        lane (no host rng draws, no bound update, outputs discarded)."""
        cfg = self.cfg
        commutative = bool(getattr(cfg, "commutative", False))
        states = []
        for grp, due, leader in zip(groups, dues, leaders):
            if due.size == 0:
                states.append(None)     # padding lane: no rng, no bound
                continue
            s = EpochState(
                t=np.ascontiguousarray(due["t"]),
                t0=np.ascontiguousarray(due["t0"]),
                cid=np.ascontiguousarray(due["cid"]),
                rid=np.ascontiguousarray(due["rid"]),
                kcls=(np.ascontiguousarray(due["kcls"])
                      if commutative else None),
                alive=np.asarray(grp._alive, bool),
                leader=int(leader),
                release_floor=float(grp._release_floor),
            )
            sample = next(st for st in grp.engine.stages
                          if isinstance(st, SampleStage))
            sample.run(s, grp.engine)
            states.append(s)
        with spans.span("dispatch", device=True):
            out = self._batched_dispatch(groups, states, leaders,
                                         commutative)
        for i, (grp, s) in enumerate(zip(groups, states)):
            if s is None:
                continue
            N = s.t.size
            (s.stamp, s.deadlines, s.arrivals, s.admitted, s.release,
             s.commit_time, s.fast, s.committed, s.exec_order) = \
                [o[i, :N] for o in out[:9]]
            eng = grp.engine
            deliver = next(st for st in eng.stages
                           if isinstance(st, DeliverStage))
            log = next(st for st in eng.stages if isinstance(st, LogStage))
            deliver.run(s, eng)
            log.run(s, eng)
            if eng.sanitizer is not None:
                eng.sanitizer.check_epoch(s, eng)
        return states

    def _batched_dispatch(self, groups, states, leaders,
                          commutative: bool) -> list:
        """The device half of a batched epoch: stacked pow2-padded operands
        (each group's PRE-fold pool ring; its host pool mirror advances
        here, which sampling neither reads nor draws from) and one
        `DomEngine.step` over the G groups."""
        Ga = len(groups)
        R = self.n
        n_pad = max(_pow2_bucket(s.t.size)
                    for s in states if s is not None)
        pools = np.empty((Ga, groups[0].engine.cfg.dom.window * R))
        ptrs = np.zeros(Ga, np.int64)
        cnts = np.zeros(Ga, np.int64)
        t = np.full((Ga, n_pad), np.inf)
        c2p = np.zeros((Ga, n_pad))
        owd = np.zeros((Ga, n_pad, R))
        drop = np.ones((Ga, n_pad, R), dtype=bool)
        reply = np.full((Ga, n_pad, R), np.inf)
        kcls = np.full((Ga, n_pad), -1, np.int64)
        alive = np.zeros((Ga, R), dtype=bool)
        lead = np.asarray(leaders, np.int64)
        n_valid = np.zeros(Ga, np.int64)
        floor = np.zeros(Ga)
        for i, (grp, s) in enumerate(zip(groups, states)):
            eng = grp.engine
            pools[i], ptrs[i], cnts[i] = eng.device_pool_state()
            alive[i] = grp._alive
            if s is None:
                continue
            s.bound = eng.update_bound(eng.observed_owd_samples(s))
            N = s.t.size
            t[i, :N] = s.t
            c2p[i, :N] = s.c2p
            owd[i, :N] = s.owd_pr
            drop[i, :N] = s.drop_pr
            rep = s.reply_owd.copy()
            rep[:, ~s.alive] = np.inf
            reply[i, :N] = s.reply_owd
            s.reply_owd = rep
            if s.kcls is not None:
                kcls[i, :N] = s.kcls
            n_valid[i] = N
            floor[i] = s.release_floor
        # the config scalars (the margin too: no group here runs a modeled
        # sync loop) are group 0's, shared by every group
        return groups[0].engine.step(
            pools, ptrs, cnts, t, c2p, owd, drop, reply, alive, kcls, lead,
            n_valid, use_kcls=commutative, release_floor=floor)


def make_sharded(cfg: ShardedConfig, **kw) -> ShardedNezhaCluster:
    return ShardedNezhaCluster(cfg, **kw)


__all__ = ["ShardedConfig", "ShardedNezhaCluster", "make_sharded"]
