"""The port's sharded Nezha (`repro_torch.core.sharded`, ``nezha-sharded``)
against the reference's numpy tier, and its batched path against its
sequential one, on the CPU.

  * ``nezha-sharded`` with ``device="cpu"`` equals the reference's
    ``nezha-sharded`` with ``tier="numpy"`` bit for bit -- summary, merged
    latencies, each group's commit trace -- at G 4 with multi-key ops and
    through a group's leader crash; G 1 equals the port's
    ``nezha-vectorized``;
  * ``vmap_groups=True`` (all groups' epochs through one call of the epoch
    body over a leading G axis) equals sequential per-group dispatch bit
    for bit at G 2, 4 and 16, with an idle group and in-epoch retry
    generations; the body over G equals G calls at G 1, and the batched
    plain DOM kernels equal per-group calls, with ragged valid lengths and
    padding lanes;
  * routing is stable across PYTHONHASHSEED, closed loop is refused at
    G > 1, global replica ids route faults to their group;
  * the two sharded scenarios equal the reference's, trace part by trace
    part, with the checkers' findings the same both ways.

The reference's numpy tier needs no JAX x64, so everything here runs on the
CPU; the card cases are in tests/test_torch_cuda.py.
"""
import copy
import dataclasses
import hashlib
import os
import subprocess
import sys
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core import engine as r_engine
from repro.core.registry import make_cluster as r_make
from repro.core.sharded import ShardedConfig as RShardedConfig
from repro.core.vectorized import dom_admit_watermark_np
from repro.sim import trace as RT
from repro.sim.workload import Workload as RWorkload
from repro.sim.workload import WorkloadDriver as RDriver
from repro.sim.workload import route_keys as r_route_keys
from repro_torch.core import ShardedConfig, make_cluster
from repro_torch.core import engine as p_engine
from repro_torch.core.engine import _build_epoch_body
from repro_torch.core.sharded import ShardedNezhaCluster
from repro_torch.kernels.dom_admit import dom_admit_plain
from repro_torch.kernels.dom_release import dom_release_plain
from repro_torch.kernels.ops import dom_deadline_order_device
from repro_torch.sim import scenario as PS
from repro_torch.sim import trace as PT
from repro_torch.sim.network import NetworkParams
from repro_torch.sim.workload import Workload, WorkloadDriver, route_keys

SHARDED = "nezha-sharded"
_W = dict(mode="open", rate_per_client=2000.0, duration=0.1, warmup=0.02,
          drain=0.1, seed=1)
_W_MULTI = dict(_W, multiop_ratio=0.15, multiop_span=3, seed=3)
TRACE_PARTS = ("log", "commits", "stamps", "sync", "durability",
               "replica_logs", "net_windows", "order_scope")


def _same(a, b, where="") -> None:
    """Bit-for-bit equality through nested dicts, lists and arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _summary(s: dict, *drop) -> dict:
    return {k: v for k, v in s.items() if k not in ("tier",) + drop}


def _group_state(grp) -> dict:
    """Everything a group accumulates: latencies, the commit records, the
    replica log."""
    lat = np.concatenate(grp._latencies) if grp._latencies else np.zeros(0)
    recs = [np.concatenate([np.asarray(r[i]) for r in grp._trace_commits])
            if grp._trace_commits else np.zeros(0) for i in range(5)]
    return {"latencies": lat, "commits": recs,
            "log": grp.engine.logs.log_columns(),
            "epochs": grp._epochs, "batches": grp._batches,
            "leaders": list(grp.epoch_leaders)}


def _same_sharded_trace(mine, ref) -> None:
    assert isinstance(mine, PT.ShardedTrace)
    assert isinstance(ref, RT.ShardedTrace)
    assert (mine.protocol, mine.backend) == (ref.protocol, ref.backend)
    assert mine.tier == "torch-cpu" and ref.tier == "numpy"
    assert len(mine.groups) == len(ref.groups)
    for g, (a, b) in enumerate(zip(mine.groups, ref.groups)):
        for part in TRACE_PARTS:
            _same(getattr(a, part), getattr(b, part), f"group {g} {part}")
    _same(mine.multiops, ref.multiops, "multiops")
    _same(mine.commit_uids, ref.commit_uids, "commit_uids")


def _run_both(w: dict, **cfg):
    ref = r_make(SHARDED, RShardedConfig(tier="numpy", **cfg))
    RDriver(RWorkload(**w)).run(ref)
    mine = make_cluster(SHARDED, ShardedConfig(device="cpu", **cfg))
    WorkloadDriver(Workload(**w)).run(mine)
    return mine, ref


# ---------------------------------------------------------------------------
# the port == the reference's numpy tier
# ---------------------------------------------------------------------------
def test_g4_with_multiops_equals_the_reference():
    mine, ref = _run_both(_W_MULTI, groups=4, n_clients=4)
    _same(_summary(mine.summary()), _summary(ref.summary()), "summary")
    assert mine.summary()["cross_group_ops"] > 10
    lat_p, fast_p = mine._merged_latencies()
    lat_r, fast_r = ref._merged_latencies()
    _same(lat_p, lat_r, "merged latencies")
    assert fast_p == fast_r
    _same_sharded_trace(PT.CommitTrace.from_cluster(mine),
                        RT.CommitTrace.from_cluster(ref))
    for g, (a, b) in enumerate(zip(mine.groups, ref.groups)):
        _same(a._pending.uids(), b._pending.uids(), f"group {g} pending")


def test_g4_through_a_group_leader_crash_equals_the_reference():
    """Global replica id 3 is group 1's replica 0, its first leader: group
    1 view-changes and recovers, the others commit on."""
    ref = r_make(SHARDED, RShardedConfig(tier="numpy", groups=4,
                                         n_clients=4))
    mine = make_cluster(SHARDED, ShardedConfig(device="cpu", groups=4,
                                               n_clients=4))
    for cl, drv in ((ref, RDriver(RWorkload(**_W_MULTI))),
                    (mine, WorkloadDriver(Workload(**_W_MULTI)))):
        drv.inject_open_loop(cl)
        cl.run_for(0.05)
        cl.crash(3)
        cl.run_for(0.15)
    s = mine.summary()
    assert s["per_group_view_changes"] == [0, 1, 0, 0]
    _same(_summary(s), _summary(ref.summary()), "summary")
    _same(mine._merged_latencies()[0], ref._merged_latencies()[0], "lat")
    _same_sharded_trace(PT.CommitTrace.from_cluster(mine),
                        RT.CommitTrace.from_cluster(ref))


def test_g1_equals_the_ports_vectorized_backend():
    one = make_cluster(SHARDED, ShardedConfig(groups=1, n_clients=4,
                                              device="cpu"))
    s1 = WorkloadDriver(Workload(**_W_MULTI)).run(one)
    base = make_cluster("nezha-vectorized", ShardedConfig(
        groups=1, n_clients=4, device="cpu"))
    s0 = WorkloadDriver(Workload(**_W_MULTI)).run(base)
    extras = ("protocol", "backend", "groups", "per_group_view_changes",
              "cross_group_ops", "vmap_epochs")
    _same(_summary(s1, *extras), _summary(s0, *extras), "summary")
    assert (s1["protocol"], s1["backend"]) == (SHARDED, "sharded")
    assert s1["tier"] == s0["tier"] == "torch-cpu"
    _same(_group_state(one.groups[0]), _group_state(base), "group 0")
    closed = Workload(mode="closed", duration=0.05, drain=0.05, seed=0)
    c1 = WorkloadDriver(closed).run(make_cluster(SHARDED, ShardedConfig(
        groups=1, n_clients=2, device="cpu")))
    c0 = WorkloadDriver(closed).run(make_cluster(
        "nezha-vectorized", ShardedConfig(n_clients=2, device="cpu")))
    assert c1["committed"] == c0["committed"] > 0
    assert c1["median_latency"] == c0["median_latency"]


def test_pending_uids_equal_the_references():
    mine, ref = p_engine.PendingBuffer(2), r_engine.PendingBuffer(2)
    assert mine.uids().size == ref.uids().size == 0
    rng = np.random.default_rng(0)
    for cid, rid in zip(rng.integers(0, 9, 40), rng.integers(0, 1 << 40, 40)):
        for buf in (mine, ref):
            buf.append(0.5, int(cid), int(rid), -1)
    _same(mine.uids(), ref.uids())
    mine.pop_due(1.0)
    assert mine.uids().dtype == np.int64 and mine.uids().size == 0


# ---------------------------------------------------------------------------
# the batched path == the sequential path
# ---------------------------------------------------------------------------
def _batched_vs_sequential(G: int):
    """A workload whose keys skip group G - 1 (an idle group every epoch),
    on a lossy fabric with a client timeout shorter than an epoch, so
    retries fall due inside their epoch (further generations)."""
    rng = np.random.default_rng(G)
    n = 600
    t = np.sort(rng.uniform(0.0, 0.08, n))
    cid = rng.integers(0, 8, n)
    keys = rng.integers(0, 1 << 20, 4 * n, dtype=np.uint64)
    keys = keys[route_keys(keys, G) != G - 1][:n]
    assert keys.size == n
    out = {}
    for vmap in (False, True):
        cfg = ShardedConfig(groups=G, n_clients=8, device="cpu", seed=G,
                            vmap_groups=vmap, client_timeout=4e-3,
                            net=NetworkParams(drop_prob=0.02))
        cl = make_cluster(SHARDED, cfg)
        retries = [0]
        for grp in cl.groups:
            run_epoch = grp.engine.run_epoch

            def counted(*a, _run=run_epoch, **kw):
                retries[0] += 1
                return _run(*a, **kw)
            grp.engine.run_epoch = counted
        for ti, ci, ki in zip(t, cid, keys):
            cl.submit_at(float(ti), int(ci), keys=(int(ki),))
        cl.run_for(0.05)
        cl.run_for(0.1)
        out[vmap] = (cl, retries[0])
    return out


@pytest.mark.parametrize("G", [2, 4, 16])
def test_batched_equals_sequential(G):
    out = _batched_vs_sequential(G)
    (seq, _), (bat, retry_gens) = out[False], out[True]
    assert seq.vmap_epochs == 0 and bat.vmap_epochs > 0
    assert retry_gens > 0          # in-epoch retry generations, per group
    assert bat.groups[G - 1]._batches == 0      # the idle group
    s_seq, s_bat = seq.summary(), bat.summary()
    assert s_bat["vmap_epochs"] == bat.vmap_epochs
    _same(_summary(s_bat, "vmap_epochs"), _summary(s_seq, "vmap_epochs"))
    _same(bat._merged_latencies()[0], seq._merged_latencies()[0], "lat")
    for g, (a, b) in enumerate(zip(bat.groups, seq.groups)):
        _same(_group_state(a), _group_state(b), f"group {g}")
    ta = PT.CommitTrace.from_cluster(bat)
    tb = PT.CommitTrace.from_cluster(seq)
    for g, (a, b) in enumerate(zip(ta.groups, tb.groups)):
        for part in TRACE_PARTS:
            _same(getattr(a, part), getattr(b, part), f"group {g} {part}")


def _ragged_batch(G: int, n_pad: int, R: int, seed: int):
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, n_pad + 1, G)
    n_valid[0] = n_pad
    n_valid[-1] = 1
    d = np.full((G, n_pad), np.inf)
    a = np.full((G, n_pad, R), np.inf)
    for g, n in enumerate(n_valid):
        d[g, :n] = rng.integers(0, 64, n) / 16.0      # exact ties
        a[g, :n] = d[g, :n, None] + rng.integers(-8, 8, (n, R)) / 16.0
        a[g, :n][rng.random((n, R)) < 0.05] = np.inf
    return n_valid, d, a


@pytest.mark.parametrize("G,n_pad", [(3, 64), (16, 256), (5, 1024)])
def test_batched_plain_kernels_equal_per_group_calls(G, n_pad):
    """The batched plain dom_admit/dom_release over [G, ...] with ragged
    valid lengths and +inf padding lanes equal G separate calls, and each
    group's valid rows equal the reference's numpy oracle on them alone."""
    n_valid, d, a = _ragged_batch(G, n_pad, 3, G * n_pad)
    dt, at = torch.as_tensor(d), torch.as_tensor(a)
    adm = dom_admit_plain(dt, at)
    order = dom_deadline_order_device(dt)
    rel, cnt = dom_release_plain(dt, adm[..., 0], 2.0)
    assert adm.shape == (G, n_pad, 3) and order.shape == (G, n_pad)
    assert rel.shape == (G, n_pad) and cnt.shape == (G,)
    for g, n in enumerate(n_valid):
        assert torch.equal(adm[g], dom_admit_plain(dt[g], at[g]))
        assert torch.equal(order[g], dom_deadline_order_device(dt[g]))
        o1, c1 = dom_release_plain(dt[g], adm[g, :, 0], 2.0)
        assert torch.equal(rel[g], o1) and int(cnt[g]) == int(c1)
        want = dom_admit_watermark_np(d[g, :n], a[g, :n])
        np.testing.assert_array_equal(adm[g, :n].numpy(), want)
        np.testing.assert_array_equal(
            order[g, :n].numpy(), np.argsort(d[g, :n], kind="stable"))


@pytest.mark.parametrize("use_kcls,use_cap", [(True, False), (False, True)])
def test_body_over_groups_equals_one_call_per_group(use_kcls, use_cap):
    """The epoch body over [G, ...] with ragged valid lengths, per-group
    leaders, floors and ring pools equals G calls at G 1 on each group's
    own pow2 bucket, on every valid row and in the carried pool."""
    G, R, W = 4, 3, 48
    rng = np.random.default_rng(7)
    n_valid = np.array([37, 5, 64, 1])
    n_pad = 64
    body = _build_epoch_body(1, use_kcls, use_cap)
    pool = rng.lognormal(np.log(60e-6), 0.5, (G, W))
    cnt = np.array([0, 7, W, 20])
    ptr = cnt % W
    pool[np.arange(W)[None, :] >= cnt[:, None]] = np.inf
    t = np.full((G, n_pad), np.inf)
    c2p = np.zeros((G, n_pad))
    owd = np.zeros((G, n_pad, R))
    drop = np.ones((G, n_pad, R), bool)
    reply = np.full((G, n_pad, R), np.inf)
    kcls = np.full((G, n_pad), -1)
    for g, n in enumerate(n_valid):
        t[g, :n] = np.sort(rng.uniform(0, 1e-2, n))
        c2p[g, :n] = rng.lognormal(np.log(30e-6), 0.4, n)
        owd[g, :n] = rng.lognormal(np.log(60e-6), 0.6, (n, R))
        drop[g, :n] = rng.random((n, R)) < 0.05
        reply[g, :n] = rng.lognormal(np.log(60e-6), 0.6, (n, R))
        kcls[g, :n] = rng.integers(-1, 4, n)
    alive = np.ones((G, R), bool)
    alive[2, 1] = False
    leader = np.array([0, 1, 2, 0])
    floor = np.array([0.0, 5e-3, 0.0, 1e-3])
    sc = dict(pq01=0.5, margin=2e-6, clamp_d=1e-3, batch_delay=50e-6,
              cap=2e-4 if use_cap else 0.0)
    up = torch.as_tensor
    carry, outs, bound = body(up(pool), up(ptr), up(cnt), up(t), up(c2p),
                              up(owd), up(drop), up(reply), up(alive),
                              up(kcls), leader, n_valid, **sc, floor=floor)
    for g, n in enumerate(n_valid):
        p = 1 << max(0, int(n - 1).bit_length())
        sl = (slice(g, g + 1), slice(0, p))
        c1, o1, b1 = body(up(pool[g:g + 1]), up(ptr[g:g + 1]),
                          up(cnt[g:g + 1]), up(t[sl]), up(c2p[sl]),
                          up(owd[sl]), up(drop[sl]), up(reply[sl]),
                          up(alive[g:g + 1]), up(kcls[sl]), leader[g:g + 1],
                          n_valid[g:g + 1], **sc, floor=floor[g:g + 1])
        assert bound[g].numpy().tobytes() == b1[0].numpy().tobytes()
        for x, y in zip(carry, c1):
            assert x[g].numpy().tobytes() == y[0].numpy().tobytes()
        for i, (x, y) in enumerate(zip(outs, o1)):
            assert x[g, :n].numpy().tobytes() == y[0, :n].numpy().tobytes(), i


# ---------------------------------------------------------------------------
# routing, closed loop, fault routing
# ---------------------------------------------------------------------------
def test_routing_is_stable_across_hashseed_and_equals_the_reference():
    keys = np.arange(0, 70_000, 7, dtype=np.uint64)
    local = route_keys(keys, 8)
    assert local.tobytes() == r_route_keys(keys, 8).tobytes()
    digest = hashlib.sha256(local.tobytes()).hexdigest()
    code = ("import hashlib, numpy as np\n"
            "from repro_torch.sim.workload import route_keys\n"
            "keys = np.arange(0, 70000, 7, dtype=np.uint64)\n"
            "print(hashlib.sha256(route_keys(keys, 8).tobytes())"
            ".hexdigest())\n")
    for seed in ("0", "1", "31337", "random"):
        env = dict(os.environ, PYTHONHASHSEED=seed,
                   PYTHONPATH=os.pathsep.join(sys.path))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == digest, f"PYTHONHASHSEED={seed}"
    for g in (2, 4, 16, 64):
        counts = np.bincount(route_keys(keys, g), minlength=g)
        assert counts.size == g and (counts > 0).all()


def test_closed_loop_is_refused_at_more_than_one_group():
    cl = make_cluster(SHARDED, ShardedConfig(groups=2, n_clients=2,
                                             device="cpu"))
    assert not cl.supports_closed_loop
    with pytest.raises(ValueError, match="closed"):
        WorkloadDriver(Workload(mode="closed", duration=0.02)).run(cl)
    with pytest.raises(NotImplementedError, match="G == 1"):
        cl.on_commit = lambda cid, rid: None
    cl.on_commit = None
    with pytest.raises(ValueError, match="groups must be >= 1"):
        ShardedNezhaCluster(ShardedConfig(groups=0, device="cpu"))


def test_global_replica_ids_route_faults_to_their_group():
    cl = make_cluster(SHARDED, ShardedConfig(groups=3, device="cpu"))
    assert cl.n == 3
    cl.crash(4)                      # group 1, replica 1
    assert [list(g._alive) for g in cl.groups] == \
        [[True] * 3, [True, False, True], [True] * 3]
    cl.relaunch(4)
    assert cl.groups[1]._alive.all()
    for rid in (-1, 9):
        with pytest.raises(ValueError, match="out of range"):
            cl.crash(rid)
    assert cl.schedule_fault(PS.GroupFault(2, PS.Crash(0.01, rid=0)))
    assert cl.groups[2]._fault_events and not cl.groups[0]._fault_events
    assert cl.schedule_fault(PS.Crash(0.02, rid=1))      # un-wrapped: group 0
    assert cl.groups[0]._fault_events
    with pytest.raises(ValueError, match="group 3 out of range"):
        cl.schedule_fault(PS.GroupFault(3, PS.Crash(0.01, rid=0)))
    cl.run_for(0.03)
    assert not cl.groups[2]._alive[0] and not cl.groups[0]._alive[1]
    assert cl.groups[1]._alive.all()


# ---------------------------------------------------------------------------
# the two sharded scenarios == the reference's
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _scenario_pair(name):
    ref = RT.run_scenario_with_trace(SHARDED, name, tier="numpy")
    mine = PT.run_scenario_with_trace(SHARDED, name, device="cpu")
    return mine, ref


def _findings(mod, trace) -> list:
    return [x.replace(trace.label, "<trace>")
            for x in mod.check_trace(trace) + mod.check_adversarial(trace)]


def _carry_sharded(trace, mod):
    """A ShardedTrace rebuilt in the other package, field by field."""
    groups = [mod.CommitTrace(**{f.name: copy.deepcopy(getattr(g, f.name))
                                 for f in dataclasses.fields(g)})
              for g in trace.groups]
    return mod.ShardedTrace(protocol=trace.protocol, backend=trace.backend,
                            tier=trace.tier, groups=groups,
                            multiops=copy.deepcopy(trace.multiops))


@pytest.mark.parametrize("name", ["sharded-multi-key", "sharded-group-crash"])
def test_sharded_scenarios_equal_the_reference(name):
    (pres, ptr), (rres, rtr) = _scenario_pair(name)
    assert pres.tier == "torch-cpu" and rres.tier == "numpy"
    for key in PS.SCENARIO_RESULT_KEYS:
        if key != "tier":
            _same(getattr(pres, key), getattr(rres, key), key)
    _same({k: v for k, v in pres.raw.items() if k != "tier"},
          {k: v for k, v in rres.raw.items() if k != "tier"}, "raw")
    assert pres.skipped_faults == 0 and pres.committed > 0
    _same_sharded_trace(ptr, rtr)
    if name == "sharded-group-crash":
        assert pres.raw["per_group_view_changes"] == [0, 1, 0, 0]
        assert pres.applied_faults == 1
    else:
        assert pres.raw["cross_group_ops"] > 100
        assert pres.cross_group_violations == 0
        assert PT.check_cross_group_linearizability(ptr) == []


@pytest.mark.parametrize("name", ["sharded-multi-key", "sharded-group-crash"])
def test_sharded_findings_are_the_references_both_ways(name):
    (_, ptr), (_, rtr) = _scenario_pair(name)
    want = _findings(RT, rtr)
    assert _findings(PT, ptr) == want
    assert _findings(PT, _carry_sharded(rtr, PT)) == want
    assert _findings(RT, _carry_sharded(ptr, RT)) == want
    assert PT.check_cross_group_linearizability(ptr) == \
        RT.check_cross_group_linearizability(rtr)


def test_sharded_scenario_batched_equals_sequential():
    """`sharded-group-crash` with the batched path on: eligibility is
    decided per `run_for`, and with a fault scheduled in group 1 the run
    takes the sequential path (no batched epoch), equal to it."""
    cfg = replace(PS.build_config(SHARDED, "sharded-group-crash"),
                  device="cpu")
    seq = PT.run_scenario_with_trace(SHARDED, "sharded-group-crash",
                                     config=cfg)
    bat = PT.run_scenario_with_trace(
        SHARDED, "sharded-group-crash", config=replace(cfg,
                                                       vmap_groups=True))
    assert bat[0].raw["vmap_epochs"] == 0
    _same(bat[0].raw, seq[0].raw, "raw")
    for g, (a, b) in enumerate(zip(bat[1].groups, seq[1].groups)):
        for part in TRACE_PARTS:
            _same(getattr(a, part), getattr(b, part), f"group {g} {part}")
