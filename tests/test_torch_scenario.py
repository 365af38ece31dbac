"""The port's scenario catalog (`repro_torch.sim.scenario`) against the
reference's (`repro.sim.scenario`): every cataloged scenario, run on the
CPU through `run_scenario_on_cluster("nezha-vectorized", name,
device="cpu")`, against the reference's numpy tier.

Tolerance: bit for bit -- every key of `SCENARIO_RESULT_KEYS` and of the
raw summary except ``tier`` (``torch-cpu`` against ``numpy``), and the
commit trace: log and commit columns, stamps, clock-sync evidence,
durability events, per-replica logs and fault windows. The findings of
`check_trace` and `check_adversarial` must be equal both ways (each
package's checkers on the other's trace, carried across field by field)
apart from the trace label, and `check_equivalent_commits` between the two
runs must find nothing.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest

from repro.sim import scenario as RS
from repro.sim import trace as RT
from repro_torch.core import registry
from repro_torch.core.dom import DomParams
from repro_torch.core.engine import DomEngine
from repro_torch.core.vectorized_cluster import VectorizedConfig
from repro_torch.sim import scenario as PS
from repro_torch.sim import trace as PT

NAMES = RS.available_scenarios()
PROTOCOL = "nezha-vectorized"


@lru_cache(maxsize=None)
def _ref(name):
    res, cl = RS.run_scenario_on_cluster(PROTOCOL, name, tier="numpy")
    return res, RT.CommitTrace.from_cluster(cl)


@lru_cache(maxsize=None)
def _port(name):
    res, cl = PS.run_scenario_on_cluster(PROTOCOL, name, device="cpu")
    return res, PT.CommitTrace.from_cluster(cl)


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


def _carry(trace, cls):
    """A trace rebuilt in the other package's `CommitTrace`, field by field
    (the two data classes declare the same fields)."""
    names = [f.name for f in dataclasses.fields(trace)]
    assert names == [f.name for f in dataclasses.fields(cls)]
    return cls(**{n: getattr(trace, n) for n in names})


def _findings(mod, trace) -> list:
    return [x.replace(trace.label, "<trace>")
            for x in mod.check_trace(trace) + mod.check_adversarial(trace)]


def _spec(sc) -> dict:
    """A scenario as plain data (fault events by type name and fields)."""
    d = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)
         if f.name not in ("faults", "workload", "environment")}
    d["faults"] = [(type(ev).__name__, ev.kind, _event(ev)) for ev in sc.faults]
    d["workload"] = dataclasses.asdict(sc.workload)
    d["env"] = (sc.env.name, sc.env.net_profile, sc.env.clock_regime,
                sc.env.overrides)
    return d


def _event(ev):
    if ev.kind == "group-fault":
        return (ev.group, type(ev.event).__name__, _event(ev.event))
    return dataclasses.asdict(ev)


# ---------------------------------------------------------------------------
# the catalog itself
# ---------------------------------------------------------------------------
def test_catalog_names_families_and_environments_equal_the_reference():
    assert PS.available_scenarios() == NAMES and len(NAMES) == 28
    for fam in ("ADVERSARIAL_SCENARIOS", "SHARDED_SCENARIOS",
                "SYNC_SCENARIOS", "SCENARIO_RESULT_KEYS", "NET_FAULT_KINDS"):
        assert getattr(PS, fam) == getattr(RS, fam), fam
    assert list(PS.ENVIRONMENTS) == list(RS.ENVIRONMENTS)
    for name, env in RS.ENVIRONMENTS.items():
        mine = PS.ENVIRONMENTS[name]
        assert (mine.net_profile, mine.clock_regime, mine.overrides) == \
            (env.net_profile, env.clock_regime, env.overrides)
        assert dataclasses.asdict(mine.net) == dataclasses.asdict(env.net)
        assert dataclasses.asdict(mine.clock) == dataclasses.asdict(env.clock)
    assert list(PS.NET_PROFILES) == list(RS.NET_PROFILES)
    assert list(PS.CLOCK_REGIMES) == list(RS.CLOCK_REGIMES)


@pytest.mark.parametrize("name", NAMES)
def test_scenario_spec_and_config_equal_the_reference(name):
    """Each cataloged scenario declares the same environment, faults,
    workload and overrides, and `build_config` gives the same config field
    for field (the reference's ``tier`` is the port's ``device``)."""
    mine, theirs = PS.get_scenario(name), RS.get_scenario(name)
    assert _spec(mine) == _spec(theirs)
    assert _spec(mine.control()) == _spec(theirs.control())
    assert mine.horizon == theirs.horizon
    cfg = dataclasses.asdict(PS.build_config(PROTOCOL, name))
    ref = dataclasses.asdict(RS.build_config(PROTOCOL, name))
    assert cfg.pop("device") == "cuda" and ref.pop("tier") == "numpy"
    assert cfg == ref


# ---------------------------------------------------------------------------
# every scenario on the CPU == the reference's numpy tier, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_scenario_equals_the_reference_bitwise(name):
    (rres, rtr), (pres, ptr) = _ref(name), _port(name)
    assert pres.tier == "torch-cpu" and rres.tier == "numpy"
    for key in PS.SCENARIO_RESULT_KEYS:
        if key != "tier":
            _same(getattr(pres, key), getattr(rres, key), key)
    raw_p = {k: v for k, v in pres.raw.items() if k != "tier"}
    raw_r = {k: v for k, v in rres.raw.items() if k != "tier"}
    _same(raw_p, raw_r, "raw")
    assert pres.committed > 0
    assert pres.skipped_faults == (1 if name == "sharded-group-crash" else 0)
    for part in ("log", "commits", "stamps", "sync", "durability",
                 "replica_logs", "net_windows", "order_scope"):
        _same(getattr(ptr, part), getattr(rtr, part), part)
    assert (ptr.protocol, ptr.backend, ptr.tier) == \
        ("nezha", "vectorized", "torch-cpu")


@pytest.mark.parametrize("name", NAMES)
def test_findings_are_the_references_both_ways(name):
    """`check_trace` + `check_adversarial`: the port's checkers on its own
    trace and on the reference's, and the reference's checkers on the
    port's trace, all give the reference's findings."""
    (_, rtr), (_, ptr) = _ref(name), _port(name)
    want = _findings(RT, rtr)
    assert _findings(PT, ptr) == want
    assert _findings(PT, _carry(rtr, PT.CommitTrace)) == want
    assert _findings(RT, _carry(ptr, RT.CommitTrace)) == want
    assert PT.check_equivalent_commits(ptr, _carry(rtr, PT.CommitTrace)) == []
    assert RT.check_equivalent_commits(_carry(ptr, RT.CommitTrace), rtr) == []


# ---------------------------------------------------------------------------
# the card phase's scale, and K-epoch windows
# ---------------------------------------------------------------------------
def _at_rate(mod, name, rate):
    sc = mod.get_scenario(name)
    return dataclasses.replace(
        sc, workload=dataclasses.replace(sc.workload, rate_per_client=rate))


def test_leader_crash_at_1e6_requests_per_second_equals_the_reference():
    """`leader-crash` at the card phase's scale (10 clients x 1e5 req/s,
    about 1e4 requests an epoch, `epochs_per_dispatch` 16), on both CPU
    sides, bit for bit."""
    rs = _at_rate(RS, "leader-crash", 1e5)
    rcfg = RS.build_config(PROTOCOL, rs)
    rcfg.epochs_per_dispatch = 16
    rres, rcl = RS.run_scenario_on_cluster(PROTOCOL, rs, config=rcfg)
    ps = _at_rate(PS, "leader-crash", 1e5)
    pcfg = dataclasses.replace(PS.build_config(PROTOCOL, ps),
                               epochs_per_dispatch=16)
    pres, pcl = PS.run_scenario_on_cluster(PROTOCOL, ps, config=pcfg,
                                           device="cpu")
    assert pres.n_requests > 300_000 and pres.view_changes == 1
    for key in PS.SCENARIO_RESULT_KEYS:
        if key != "tier":
            _same(getattr(pres, key), getattr(rres, key), key)
    _same(np.concatenate(pcl._latencies), np.concatenate(rcl._latencies))
    ptr, rtr = PT.CommitTrace.from_cluster(pcl), RT.CommitTrace.from_cluster(rcl)
    for part in ("log", "commits", "stamps"):
        _same(getattr(ptr, part), getattr(rtr, part), part)
    assert pcl.epoch_leaders == rcl.epoch_leaders


def test_16_epoch_windows_equal_single_epochs_through_a_crash(monkeypatch):
    """The port at `epochs_per_dispatch` 16 against K 1 on `leader-crash`:
    a one-second client timeout keeps windows retry-closed, so they run on
    both sides of the crash, and every result and trace column is equal."""
    windows = []
    run_window = DomEngine.run_window

    def counted(self, *a, **k):
        windows.append(len(a[0]))
        return run_window(self, *a, **k)

    monkeypatch.setattr(DomEngine, "run_window", counted)
    out = {}
    for k in (1, 16):
        cfg = dataclasses.replace(PS.build_config(PROTOCOL, "leader-crash"),
                                  epochs_per_dispatch=k, client_timeout=1.0)
        res, cl = PS.run_scenario_on_cluster(PROTOCOL, "leader-crash",
                                             config=cfg, device="cpu")
        out[k] = (res, PT.CommitTrace.from_cluster(cl), cl)
    assert 16 in windows and res.view_changes == 1
    (r1, t1, c1), (r16, t16, c16) = out[1], out[16]
    for key in PS.SCENARIO_RESULT_KEYS:
        _same(getattr(r16, key), getattr(r1, key), key)
    for part in ("log", "commits", "stamps"):
        _same(getattr(t16, part), getattr(t1, part), part)
    assert c16.epoch_leaders == c1.epoch_leaders


# ---------------------------------------------------------------------------
# the entry points: device, registry, overrides, validation
# ---------------------------------------------------------------------------
class _Built(Exception):
    pass


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(
        monkeypatch, device):
    """With no ``device`` the config `run_scenario`, `make_scenario_cluster`
    and `run_scenario_with_trace` hand the registry asks for the card
    (checked on the config; nothing runs)."""
    seen = []

    def capture(name, cfg, **kw):
        seen.append((name, cfg))
        raise _Built

    monkeypatch.setattr(registry, "make_cluster", capture)
    kw = {} if device is None else {"device": device}
    for entry in (PS.run_scenario, PS.make_scenario_cluster,
                  PT.run_scenario_with_trace):
        with pytest.raises(_Built):
            entry(PROTOCOL, "leader-crash", **kw)
    assert len(seen) == 3
    for name, cfg in seen:
        assert name == PROTOCOL and isinstance(cfg, VectorizedConfig)
        assert cfg.device == (device or "cuda")
        assert cfg.n_proxies == 2 and cfg.f == 1 and cfg.n_clients == 10


def test_other_protocols_fail_with_the_available_names():
    """Names the port does not register (the reference's tier-pinned ones)
    fail in the registry, listing the names it has."""
    for entry in (PS.run_scenario, PS.build_config):
        with pytest.raises(KeyError, match="available: nezha, nezha-nonproxy,"
                           " nezha-vectorized, nezha-sharded, multipaxos"):
            entry("nezha-vectorized-jit", "intra-zone")
    assert registry.config_class(PROTOCOL) is VectorizedConfig


def test_dom_override_builds_the_ports_dom_params():
    cfg = PS.build_config(PROTOCOL, "wan")
    assert type(cfg.dom) is DomParams
    assert dataclasses.asdict(cfg.dom) == {**dataclasses.asdict(DomParams()),
                                           **PS._WAN_DOM}
    assert cfg.client_timeout == 400e-3 and cfg.client_proxy_lan == 150e-6
    assert not hasattr(cfg, "batch_interval")       # no such knob: skipped
    capped = PS.build_config(PROTOCOL, "clock-skew-leader-capped")
    assert capped.deadline_cap == 50e-6 and capped.n_proxies == 2


_BAD = {
    "relaunch-before-crash": lambda m: dict(faults=(m.Relaunch(0.1, rid=0),)),
    "double-crash": lambda m: dict(faults=(m.Crash(0.05, rid=0),
                                           m.Crash(0.1, rid=0))),
    "outside-horizon": lambda m: dict(faults=(m.Crash(0.5, rid=0),)),
    "sub-quorum": lambda m: dict(f=2, overrides={"n_replicas": 3}),
    "unknown-environment": lambda m: dict(environment="mars"),
    "unknown-net-profile": lambda m: dict(
        faults=(m.NetShift(0.05, profile="carrier-pigeon"),)),
    "uncovering-partition": lambda m: dict(
        faults=(m.Partition(0.01, groups=((0,), (1,))),)),
    "heal-without-partition": lambda m: dict(faults=(m.Heal(0.01),)),
    "gray-endpoint": lambda m: dict(
        faults=(m.GrayLink(0.01, "replica:7", "*", drop_prob=0.1),)),
    "gray-no-effect": lambda m: dict(faults=(m.GrayLink(0.01),)),
    "stamper-range": lambda m: dict(
        faults=(m.SkewedStamper(0.01, proxy_id=9, bias=1e-4),)),
    "sync-restore-first": lambda m: dict(faults=(m.SyncRestore(0.05),)),
    "clock-leap-zero": lambda m: dict(faults=(m.ClockLeap(0.05, delta=0.0),)),
    "group-range": lambda m: dict(
        groups=2, faults=(m.GroupFault(3, m.Crash(0.05, rid=0)),)),
    "every-error-at-once": lambda m: dict(
        f=0, environment="mars", faults=(m.Relaunch(0.9, rid=0),)),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_validation_raises_the_references_message(case):
    msgs = []
    for mod in (RS, PS):
        work = mod.Workload(mode="open", rate_per_client=100.0,
                            duration=0.2, drain=0.1)
        with pytest.raises(ValueError) as exc:
            mod.Scenario("bad", workload=work, **_BAD[case](mod))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
