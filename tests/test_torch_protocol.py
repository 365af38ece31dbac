"""The port's event-driven backends (`repro_torch.core.protocol`'s Nezha and
`repro_torch.core.baselines`' eight protocols) against the reference's, bit
for bit, on the CPU.

Each side builds the same config from the same fields and seed, in its own
package, and runs the same workload (open loop, numpy-seeded). Compared
exactly: every summary key; every request's record (submit and commit time,
fast path, retries, result) -- so the whole commit-latency array; and for
Nezha each replica's state: its synced log (deadlines, uids, order), the
unsynced tail, the incremental hash (with and without the crash vector),
the per-key hash table, view, status, crash vector, the sync / commit /
executed points and the message counters. Recovery draws a random nonce
(`uuid.uuid4`), which no comparison reads.

Per-key hashes key non-int keys by Python's salted `hash`, so both sides
are compared in the same process only.
"""
import dataclasses
import math

import numpy as np
import pytest

import repro.core as R
import repro.core.baselines as RB
import repro.core.registry as RR
import repro.sim.network as RN
import repro.sim.workload as RW
import repro_torch.core as P
import repro_torch.core.baselines as PB
import repro_torch.core.registry as PR
import repro_torch.sim.network as PN
import repro_torch.sim.workload as PW

REF = dict(core=R, reg=RR, base=RB, net=RN, wl=RW)
PORT = dict(core=P, reg=PR, base=PB, net=PN, wl=PW)

BASELINES = ("multipaxos", "raft", "fastpaxos", "nopaxos", "nopaxos-optim",
             "domino", "toq-epaxos", "unreplicated")


def _same(a, b, path="") -> None:
    """Exact equality through dicts, sequences, enums and dataclasses, with
    NaN equal to NaN and numpy scalars equal to Python ones."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        _same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a),
                                                            list(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif hasattr(a, "value") and hasattr(type(a), "__members__"):  # enum
        assert a.value == b.value, path
    elif isinstance(a, (float, np.floating)) and math.isnan(a):
        assert isinstance(b, (float, np.floating)) and math.isnan(b), path
    else:
        assert a == b and type(a) in (type(b), int, float, bool,
                                      np.float64, np.int64, np.bool_,
                                      np.uint64), (path, a, b)


def _replica_state(r) -> dict:
    key3 = lambda e: (e.deadline, e.client_id, e.request_id)  # noqa: E731
    return {
        "alive": r.alive, "status": r.status.value, "view": r.view_id,
        "last_normal_view": r.last_normal_view,
        "crash_vector": tuple(r.crash_vector),
        "synced": [key3(e) for e in r.synced],
        "unsynced": [key3(e) for e in r.unsynced.values()],
        "hash": r.ghash.value, "set_hash": r.ghash.set_hash,
        "key_hashes": {int(k): int(v) for k, v in r.khash._table.items()},
        "points": (r.sync_point, r.commit_point, r.executed_point),
        "results": {uid: res for uid, res in r.results.items()},
        "stats": dict(r.stats), "divergent": r.divergent,
    }


def _nezha_state(cl) -> dict:
    return {
        "summary": cl.summary(),
        "records": {(c.id, rid): dataclasses.asdict(rec)
                    for c in cl.clients for rid, rec in c.records.items()},
        "replicas": [_replica_state(r) for r in cl.replicas],
        "view_changes": cl.view_changes, "leader": cl.leader_id,
        "now": cl.now, "messages": cl.fabric.msg_count,
    }


def _latencies(cl) -> np.ndarray:
    return np.asarray([rec.commit_time - rec.submit_time
                       for c in cl.clients for rec in c.records.values()])


def _run_nezha(pkg, name, steps, *, workload, net=None, **cfg_kw):
    """Build ``name`` from ``pkg``, inject ``workload`` (open loop), then
    walk ``steps``: ("run", dt), ("crash", rid) or ("relaunch", rid)."""
    if net is not None:
        cfg_kw["net"] = pkg["net"].NetworkParams(**net)
    cl = pkg["reg"].make_cluster(name, pkg["core"].ClusterConfig(**cfg_kw))
    cl.start()
    pkg["wl"].WorkloadDriver(pkg["wl"].Workload(**workload)) \
        .inject_open_loop(cl)
    for kind, arg in steps:
        if kind == "run":
            cl.run_for(arg)
        else:
            getattr(cl, kind)(arg)
    return cl


OPEN = dict(rate_per_client=500.0, duration=0.05, seed=0)
CASES = {
    "fault-free": dict(steps=[("run", 0.15)], workload=OPEN,
                       f=1, n_proxies=1, n_clients=10, seed=0),
    "follower-crash": dict(
        steps=[("run", 0.03), ("crash", 2), ("run", 0.05), ("relaunch", 2),
               ("run", 0.15)],
        workload=dict(OPEN, duration=0.1), f=1, n_proxies=1, n_clients=10,
        seed=3),
    "leader-crash-relaunch": dict(
        steps=[("run", 0.03), ("crash", 0), ("run", 0.08), ("relaunch", 0),
               ("run", 0.2)],
        workload=dict(OPEN, duration=0.15), f=1, n_proxies=2, n_clients=10,
        seed=5),
    "heavy-loss": dict(steps=[("run", 0.3)], workload=OPEN,
                       net=dict(drop_prob=0.01), f=1, n_proxies=1,
                       n_clients=10, seed=8),
    "f2": dict(steps=[("run", 0.15)], workload=OPEN, f=2, n_proxies=2,
               n_clients=10, seed=2),
    "f2-leader-crash": dict(
        steps=[("run", 0.03), ("crash", 0), ("run", 0.1), ("relaunch", 0),
               ("run", 0.15)],
        workload=dict(OPEN, duration=0.1), f=2, n_proxies=1, n_clients=10,
        seed=4),
}


@pytest.mark.parametrize("name", ["nezha", "nezha-nonproxy"])
@pytest.mark.parametrize("case", list(CASES))
def test_nezha_equals_the_reference(name, case):
    spec = dict(CASES[case])
    steps = spec.pop("steps")
    ref = _run_nezha(REF, name, steps, **spec)
    port = _run_nezha(PORT, name, steps, **spec)
    a, b = _nezha_state(ref), _nezha_state(port)
    _same(a, b)
    np.testing.assert_array_equal(_latencies(ref), _latencies(port))
    s = b["summary"]
    assert s["committed"] > 0 and s["backend"] == "event"
    if "crash" in case:
        assert s["view_changes"] >= (1 if "leader" in case else 0)
        assert all(r["status"] == "normal" for r in b["replicas"])
    if case == "leader-crash-relaunch":
        # the relaunched old leader rejoined as a follower with the log
        assert b["leader"] != 0 and b["replicas"][0]["synced"]


def test_nezha_kv_results_through_a_leader_crash():
    """`KVStore` commands, closed loop, through a leader crash: every
    committed result and every replica's re-executed results agree."""
    def drive(pkg):
        core = pkg["core"]
        cl = pkg["reg"].make_cluster(
            "nezha", core.ClusterConfig(f=1, n_proxies=1, n_clients=2,
                                        seed=6),
            sm_factory=core.KVStore)

        def on_commit(client, rid):
            if client.next_request_id < 120:
                client.submit(command=("RMW", "a", "b", 1),
                              op=core.OpType.RMW, keys=("a", "b"))
        for c in cl.clients:
            c.on_commit = on_commit
        cl.start()
        for c in cl.clients:
            c.submit(command=("RMW", "a", "b", 1), op=core.OpType.RMW,
                     keys=("a", "b"))
        cl.run_for(0.05)
        cl.crash(0)
        cl.run_for(0.3)
        return cl

    ref, port = drive(REF), drive(PORT)
    _same(_nezha_state(ref), _nezha_state(port))
    assert port.summary()["committed"] == 240
    assert port.replicas[port.leader_id].sm.d == ref.replicas[
        ref.leader_id].sm.d == {"a": -240, "b": 240}


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_equals_the_reference(name):
    def run(pkg):
        cfg = pkg["base"].BaselineConfig(f=1, n_clients=10, seed=1)
        cl = pkg["reg"].make_cluster(name, cfg)
        s = pkg["wl"].WorkloadDriver(pkg["wl"].Workload(**OPEN)).run(cl)
        recs = {uid: dataclasses.asdict(r) for uid, r in cl.records.items()}
        return s, recs, cl.fabric.msg_count

    a, b = run(REF), run(PORT)
    _same(a, b)
    assert b[0]["committed"] == len(b[1]) > 0


@pytest.mark.parametrize("name", ["raft", "domino"])
def test_baseline_options_equal_the_reference(name):
    """Raft with a per-fsync disk latency, Domino at another percentile
    (a constructor keyword) -- closed loop, f 2."""
    extra = {"raft": ({"disk_write_latency": 50e-6}, {}),
             "domino": ({}, {"percentile": 90.0})}[name]

    def run(pkg):
        cfg = pkg["base"].BaselineConfig(f=2, n_clients=4, seed=3, **extra[0])
        cl = pkg["reg"].make_cluster(name, cfg, **extra[1])
        s = pkg["wl"].WorkloadDriver(pkg["wl"].Workload(
            mode="closed", duration=0.03, seed=3)).run(cl)
        return s, {uid: dataclasses.asdict(r)
                   for uid, r in cl.records.items()}

    _same(run(REF), run(PORT))


# ---------------------------------------------------------------------------
# registry, configs, promotion
# ---------------------------------------------------------------------------
def test_the_registry_has_the_references_names_but_the_tiers():
    ref = RR.available_clusters()
    assert PR.available_clusters() == tuple(
        n for n in ref
        if n not in ("nezha-vectorized-jit", "nezha-vectorized-pallas"))
    assert len(PR.available_clusters()) == 12


@pytest.mark.parametrize("name", PR.available_clusters())
def test_config_class_and_promotion_match_the_reference(name):
    pc, rc = PR.config_class(name), RR.config_class(name)
    assert pc.__name__ == rc.__name__
    ref_fields = {f.name for f in dataclasses.fields(rc)}
    port_fields = {f.name for f in dataclasses.fields(pc)}
    if pc.__name__ in ("VectorizedConfig", "ShardedConfig"):
        # the port's vectorized configs pick a device, not a compute tier
        assert ref_fields - port_fields <= {"tier"}
        assert port_fields - ref_fields <= {"device"}
    else:
        assert port_fields == ref_fields
        _same(dataclasses.asdict(pc()), dataclasses.asdict(rc()))
    common = dict(f=2, n_clients=3, seed=7, client_timeout=5e-3)
    mine = PR._coerce_config(P.CommonConfig(**common), pc)
    theirs = RR._coerce_config(R.CommonConfig(**common), rc)
    assert isinstance(mine, pc)
    for k in common:
        assert getattr(mine, k) == getattr(theirs, k) == common[k]
    if pc.__name__ not in ("VectorizedConfig", "ShardedConfig"):
        _same(dataclasses.asdict(mine), dataclasses.asdict(theirs))
    with pytest.raises(TypeError):
        PR.make_cluster(name, object())


def test_nonproxy_promotes_its_config_and_unknown_names_list_the_registry():
    cl = PR.make_cluster("nezha-nonproxy", P.ClusterConfig(n_proxies=2))
    assert cl.cfg.co_locate_proxies and cl.protocol == "nezha-nonproxy"
    with pytest.raises(KeyError, match="nezha-nonproxy"):
        PR.make_cluster("nezha-vectorized-jit")
    with pytest.raises(TypeError, match="either config or scenario"):
        PR.make_cluster("nezha", P.ClusterConfig(), scenario="intra-zone")
    cl = PR.make_cluster("nezha", scenario="intra-zone")
    assert isinstance(cl.cfg, P.ClusterConfig)


def test_event_building_blocks_equal_the_reference():
    """The scheduler, clocks (legacy and modeled sync), DOM receiver and
    MERGE-LOG on the same inputs."""
    import repro.core.dom as rdom
    import repro.core.recovery as rrec
    import repro.sim.events as rev
    import repro_torch.core.dom as pdom
    import repro_torch.core.recovery as prec
    import repro_torch.sim.events as pev

    out = []
    for ev in (rev, pev):
        s, seen = ev.EventScheduler(), []
        for i, t in enumerate([3e-6, 1e-6, 1e-6, 2e-6, 0.0]):
            e = s.schedule_at(t, lambda i=i: seen.append((s.now, i)))
            if i == 3:
                e.cancel()
        s.run_for(5e-6)
        out.append((seen, s.n_dispatched, s.now))
    assert out[0] == out[1]

    for sync_model in (False, True):
        reads = []
        for core in (R, P):
            cp = core.ClockParams(sync_model=sync_model, step_rate=0.0)
            clocks = [core.Clock(i, cp, seed=4) for i in range(3)]
            clocks[1].inject_fault(5e-6, 1e-6)
            seq = []
            for t in np.linspace(0.0, 0.05, 40):
                for c in clocks:
                    seq.append((c.read_monotonic(float(t)), c.sigma_at(float(t))))
                    if t > 0.02:
                        c.resync(float(t))
            clocks[2].leap(3e-4)
            seq.append(clocks[2].read(0.06))
            reads.append(seq)
        assert reads[0] == reads[1]

    rng = np.random.default_rng(0)
    d = np.round(rng.uniform(0, 1e-3, 200), 5)     # many tied deadlines
    arr = d + rng.normal(0, 5e-5, 200)
    rel = []
    for dom, core in ((rdom, R), (pdom, P)):
        rx = dom.DomReceiver(dom.DomParams(), commutative=True)
        got = []
        for i in np.argsort(arr, kind="stable"):
            req = core.Request(client_id=int(i % 7), request_id=int(i),
                               send_time=float(d[i]) - 1e-4,
                               latency_bound=1e-4, deadline=float(d[i]),
                               keys=(int(i % 5),))
            got.append(rx.receive(req, float(arr[i]), 3e-8, 3e-8))
            got.append([r.uid for r in rx.pump(float(arr[i]))])
        rel.append((got, len(rx.late)))
    assert rel[0] == rel[1]

    def vc(msgs_pkg, rec_pkg, core):
        logs = []
        for r in range(3):
            ents = [msgs_pkg.LogEntry(float(d[i]), int(i % 7), int(i),
                                      core.Request(client_id=int(i % 7),
                                                   request_id=int(i),
                                                   deadline=float(d[i])))
                    for i in range(r, 200, 1 + r)]
            logs.append(msgs_pkg.ViewChange(r, 2, (0, 1, 0), ents,
                                            sync_point=10 * r,
                                            last_normal_view=1))
        stats = {}
        merged = rec_pkg.merge_logs(logs, 1, stats)
        return [e.key3 for e in merged], stats, rec_pkg.aggregate_crash_vectors(
            [(0, 1, 0), (2, 0, 1)]), rec_pkg.check_crash_vector((0, 2, 0), 1,
                                                                (0, 1, 0))

    import repro.core.messages as rmsg
    import repro_torch.core.messages as pmsg
    assert vc(rmsg, rrec, R) == vc(pmsg, prec, P)
