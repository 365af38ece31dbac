"""The port's commit-trace checkers (`repro_torch.sim.trace`) against the
reference's (`repro.sim.trace`).

- The ten scenarios with a paired invariant (all but `sharded-multi-key`,
  whose checker needs the sharded backend) run on the port on the CPU: the
  paired checker fires on the faulted run and every adversarial checker
  stays silent on `control()`, with the reference's finding counts.
- Every checker, on a recorded trace and on tampered copies of it, gives
  the reference's findings, message for message.
- `check_cross_group_linearizability` over the reference's `ShardedTrace`
  of `sharded-multi-key` (carried across field by field): none on the
  honest trace, the same finding after each tamper.
"""
import copy
import dataclasses
import types
from functools import lru_cache

import numpy as np
import pytest

from repro.sim import scenario as RS
from repro.sim import trace as RT
from repro_torch.core.recovery import pack_uids
from repro_torch.sim import scenario as PS
from repro_torch.sim import trace as PT

PROTOCOL = "nezha-vectorized"
PAIRED = tuple(n for n in PS.available_scenarios()
               if PS.get_scenario(n).invariant and n != "sharded-multi-key")


def _build(mod, fields: dict):
    return mod.CommitTrace(**copy.deepcopy(fields))


def _fields(trace) -> dict:
    return {f.name: copy.deepcopy(getattr(trace, f.name))
            for f in dataclasses.fields(trace)}


# ---------------------------------------------------------------------------
# paired invariants: fire on the fault, silent on the control
# ---------------------------------------------------------------------------
def test_ten_scenarios_carry_a_paired_invariant():
    assert len(PAIRED) == 10
    assert list(PT.ADVERSARIAL_CHECKS) == list(RT.ADVERSARIAL_CHECKS)
    assert all(PS.get_scenario(n).invariant in PT.ADVERSARIAL_CHECKS
               for n in PAIRED)


@pytest.mark.parametrize("name", PAIRED)
def test_paired_invariant_fires_on_the_fault_and_not_on_the_control(name):
    sc = PS.get_scenario(name)
    check = PT.ADVERSARIAL_CHECKS[sc.invariant]
    res, tr = PT.run_scenario_with_trace(PROTOCOL, sc, device="cpu")
    assert check(tr), f"{name}: invariant silent on faults"
    assert res.invariant_violations >= len(check(tr))
    res_c, tr_c = PT.run_scenario_with_trace(PROTOCOL, sc.control(),
                                             device="cpu")
    assert PT.check_adversarial(tr_c) == []
    assert res_c.invariant_violations == 0 and res_c.raw[
        "invariant_violations"] == 0
    assert PT.check_trace(tr_c) == []
    ref, _ = RT.run_scenario_with_trace(PROTOCOL, RS.get_scenario(name),
                                        tier="numpy")
    assert res.invariant_violations == ref.invariant_violations


# ---------------------------------------------------------------------------
# every checker, message for message, on a recorded trace and tampered copies
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _recorded() -> dict:
    """One `leader-minority-partition` run of the port on the CPU, with
    each replica's durable view materialized from the shared log."""
    _, tr = PT.run_scenario_with_trace(PROTOCOL, "leader-minority-partition",
                                       device="cpu")
    tr.replica_logs = {r: {"cid": tr.log["cid"].copy(),
                           "rid": tr.log["rid"].copy()} for r in range(3)}
    assert tr.net_windows and tr.log["cid"].size > 100
    return _fields(tr)


def _drop_log_row(f, i):
    for c in f["log"]:
        f["log"][c] = np.delete(f["log"][c], i)


def _duplicate_log_uid(f):
    f["log"]["cid"][10] = f["log"]["cid"][9]
    f["log"]["rid"][10] = f["log"]["rid"][9]


def _duplicate_delivery(f):
    for c in f["commits"]:
        f["commits"][c] = np.append(f["commits"][c], f["commits"][c][:1])


def _drop_committed_entry(f):
    committed = set(pack_uids(f["commits"]["cid"], f["commits"]["rid"])
                    .tolist())
    uids = pack_uids(f["log"]["cid"], f["log"]["rid"]).tolist()
    _drop_log_row(f, next(i for i, u in enumerate(uids) if u in committed))


def _reorder_within_a_batch(f):
    log = f["log"]
    key = list(zip(log["batch"].tolist(), log["kcls"].tolist()))
    seen = set()
    for i, k in enumerate(key):
        if k in seen:
            log["deadline"][i] = -1.0       # before its class's earlier row
            return
        seen.add(k)
    raise AssertionError("no batch holds two entries of one class")


def _split_brain(f):
    f["replica_logs"][1]["cid"][50] += 1000


def _durability_hole(f):
    f["durability"].append({"replica": 2, "acked": 120, "persisted": 40,
                            "missing": 80,
                            "uids": np.arange(80, dtype=np.int64)})


def _stamp_bias(f, bias=500e-6):
    pid = np.repeat(np.arange(3, dtype=np.int64), 16)
    doff = np.full(pid.size, 80e-6)
    doff[pid == 1] += bias
    f["stamps"] = {"pid": pid, "doff": doff}


def _minority_progress(f):
    t = f["commits"]["t"]
    for w in f["net_windows"]:
        if w["kind"] == "partition":
            w["minority_progress"] = int(((t >= w["t0"]) & (t < w["t1"])).sum())


def _gray_window_without_commits(f):
    t = f["commits"]["t"]
    f["net_windows"].append({"kind": "gray", "t0": float(t.max()) + 1.0,
                             "t1": float(t.max()) + 1.01})


def _sync(f, err_scale=1.0, peak=1.0, events=()):
    ticks = np.repeat(np.arange(8) * 0.02, 4)
    sigma = np.full(ticks.size, 10e-6)
    sigma[ticks == ticks[-1]] *= peak
    err = np.tile([1e-6, -2e-6, 3e-6, -1e-6], 8) * err_scale
    f["sync"] = {"t": ticks, "node": np.tile(np.arange(4), 8), "err": err,
                 "sigma": sigma, "events": list(events)}


# tamper -> (mutation, the single-trace checkers that must fire; every
# other one must stay silent). The recorded run's partition-liveness
# finding stands throughout, except where a tamper removes it.
TAMPERS = {
    "untouched": (lambda f: None, ()),
    # the overwritten uid is also gone from the log
    "duplicate-log-uid": (_duplicate_log_uid,
                          ("check_at_most_once", "check_durable_log")),
    "duplicate-delivery": (_duplicate_delivery, ("check_at_most_once",)),
    "dropped-committed-entry": (_drop_committed_entry,
                                ("check_durable_log",)),
    "reordered-within-a-batch": (_reorder_within_a_batch,
                                 ("check_deadline_order",)),
    "split-brain": (_split_brain, ("check_split_brain",)),
    "durability-hole": (_durability_hole, ("check_durability",)),
    "stamp-bias": (_stamp_bias, ("check_stamp_bias",)),
    "stamp-bias-just-past-bound": (lambda f: _stamp_bias(f, 150e-6),
                                   ("check_stamp_bias",)),
    "stamp-bias-within-bound": (lambda f: _stamp_bias(f, 50e-6), ()),
    "minority-progress": (_minority_progress, ()),
    "gray-window-without-commits": (_gray_window_without_commits, ()),
    "sync-honest": (_sync, ()),
    "sync-dishonest": (lambda f: _sync(f, err_scale=50.0),
                       ("check_sync_coverage",)),
    "sync-degraded": (lambda f: _sync(f, peak=4.0),
                      ("check_sync_degraded",)),
    "sync-step": (lambda f: _sync(f, events=[
        {"kind": "step", "node": 0, "t": 0.06, "magnitude": 300e-6}]),
        ("check_sync_step",)),
}
SINGLE = ("check_at_most_once", "check_durable_log", "check_deadline_order",
          "check_split_brain", "check_stamp_bias", "check_durability",
          "check_sync_coverage", "check_sync_degraded", "check_sync_step",
          "check_cross_group_linearizability")


@pytest.mark.parametrize("tamper", list(TAMPERS))
def test_every_checker_gives_the_references_findings(tamper):
    mutate, fires = TAMPERS[tamper]
    f = copy.deepcopy(_recorded())
    mutate(f)
    mine, theirs = _build(PT, f), _build(RT, f)
    for name in SINGLE + ("check_partition_liveness", "check_trace",
                          "check_adversarial"):
        got, want = getattr(PT, name)(mine), getattr(RT, name)(theirs)
        assert got == want, name
        if name in fires:
            assert got, f"{name} silent on {tamper}"
        elif name in SINGLE:
            assert got == [], f"{name} fired on {tamper}"
    liveness = PT.check_partition_liveness(mine)
    if tamper == "minority-progress":
        assert liveness == []
    elif tamper == "gray-window-without-commits":
        assert len(liveness) == 2 and "gray degradation" in liveness[1]
    else:
        assert len(liveness) == 1 and "partition asymmetry" in liveness[0]


def test_assert_forms_and_equivalence_match_the_reference():
    f = copy.deepcopy(_recorded())
    a_p, a_r = _build(PT, f), _build(RT, f)
    for c in f["commits"]:
        f["commits"][c] = f["commits"][c][1:]
    b_p, b_r = _build(PT, f), _build(RT, f)
    got = PT.check_equivalent_commits(a_p, b_p)
    assert got and got == RT.check_equivalent_commits(a_r, b_r)
    assert PT.check_equivalent_commits(b_p, a_p) == \
        RT.check_equivalent_commits(b_r, a_r)
    PT.assert_equivalent_commits(a_p, a_p)
    with pytest.raises(AssertionError, match="committed on"):
        PT.assert_equivalent_commits(a_p, b_p)
    _duplicate_delivery(f)
    with pytest.raises(AssertionError, match="duplicate commits"):
        PT.assert_trace_ok(_build(PT, f))
    assert PT.COMMIT_COLS == RT.COMMIT_COLS and PT.LOG_COLS == RT.LOG_COLS
    empty_p, empty_r = PT.CommitTrace("p", "b", "t"), RT.CommitTrace("p", "b", "t")
    for part in ("log", "commits", "stamps"):
        for c, v in getattr(empty_r, part).items():
            assert getattr(empty_p, part)[c].dtype == v.dtype, (part, c)


def test_unported_backends_raise_naming_the_roadmap_item():
    """`from_cluster` raises, naming the backend, for one it has no builder
    for. The event backends are ported: their builder is
    `from_event_cluster` (held against the reference's in
    tests/test_torch_event_scenario.py). The sharded backend records its
    `ShardedTrace`."""
    with pytest.raises(NotImplementedError, match="'quantum'"):
        PT.CommitTrace.from_cluster(types.SimpleNamespace(backend="quantum"))
    with pytest.raises(AttributeError, match="clients"):
        # dispatched to the event builder, which reads the clients' records
        PT.CommitTrace.from_cluster(types.SimpleNamespace(backend="event"))
    from repro_torch.core import ShardedConfig, make_cluster
    from repro_torch.sim.workload import Workload, WorkloadDriver

    cl = make_cluster("nezha-sharded", ShardedConfig(groups=2, n_clients=2,
                                                     device="cpu"))
    WorkloadDriver(Workload(duration=0.05, drain=0.05, seed=0,
                            multiop_ratio=0.3)).run(cl)
    tr = PT.CommitTrace.from_cluster(cl)
    assert isinstance(tr, PT.ShardedTrace) and len(tr.groups) == 2
    assert tr.label == "nezha-sharded/sharded/torch-cpu"
    assert tr.multiops and tr.multiops == {
        u: {"groups": m["groups"], "deadline": m["deadline"]}
        for u, m in cl._multi.items()}
    assert tr.commit_uids.size == cl.summary()["committed"] > 0
    assert PT.check_cross_group_linearizability(tr) == []


# ---------------------------------------------------------------------------
# cross-group linearizability over the reference's sharded trace
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _sharded():
    _, tr = RT.run_scenario_with_trace("nezha-sharded", "sharded-multi-key",
                                       tier="numpy")
    assert isinstance(tr, RT.ShardedTrace) and len(tr.multiops) > 100
    return tr


def _sharded_pair(tamper):
    """The reference's ShardedTrace and the port's, carried across field by
    field, both tampered the same way."""
    ref = copy.deepcopy(_sharded())
    tamper(ref)
    mine = PT.ShardedTrace(
        protocol=ref.protocol, backend=ref.backend, tier=ref.tier,
        groups=[_build(PT, _fields(g)) for g in ref.groups],
        multiops=copy.deepcopy(ref.multiops))
    return mine, ref


def _pos(tr, g, uid):
    return int(np.flatnonzero(tr.groups[g].log_uids == uid)[0])


def _swap(tr, g, ua, ub):
    i, j = _pos(tr, g, ua), _pos(tr, g, ub)
    for col in tr.groups[g].log.values():
        col[[i, j]] = col[[j, i]]


def _torn(tr):
    i = _pos(tr, 1, 0)
    for c in tr.groups[1].log:
        tr.groups[1].log[c] = np.delete(tr.groups[1].log[c], i)


def _off_deadline(tr):
    tr.groups[2].log["deadline"][_pos(tr, 2, 0)] += 1e-9


SHARDED_TAMPERS = {
    "honest": (lambda tr: None, None),
    "torn": (_torn, "torn multi-op (0, 0)"),
    "off-deadline": (_off_deadline, "off its pre-stamped deadline"),
    "opposite-orders": (lambda tr: _swap(tr, 1, 0, 2), "opposite orders"),
    "against-deadline-order": (
        lambda tr: (_swap(tr, 1, 0, 2), _swap(tr, 2, 0, 2)),
        "against global deadline order"),
}


@pytest.mark.parametrize("tamper", list(SHARDED_TAMPERS))
def test_cross_group_linearizability_matches_the_reference(tamper):
    mutate, expect = SHARDED_TAMPERS[tamper]
    mine, ref = _sharded_pair(mutate)
    got = PT.check_cross_group_linearizability(mine)
    assert got == RT.check_cross_group_linearizability(ref)
    if expect is None:
        assert got == []
    else:
        assert got and expect in got[0]
    assert mine.label == ref.label
    assert mine.commit_uids.tobytes() == ref.commit_uids.tobytes()
    assert PT.check_trace(mine) == RT.check_trace(ref)
    assert PT.check_adversarial(mine) == RT.check_adversarial(ref)
    # silent on a single-group trace
    assert PT.check_cross_group_linearizability(mine.groups[0]) == []
