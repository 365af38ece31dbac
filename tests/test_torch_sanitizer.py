"""The port's runtime invariant sanitizer (`repro_torch.core.sanitizer`)
against the reference's (`repro.core.sanitizer.SanitizerTier`).

- Each tampered `EpochState` of the reference's own sanitizer tests
  (tests/test_sanitizer.py) goes through both sanitizers: the same verdict,
  the same `violations` list, the same message but for the tier's name.
- The switches: ``cfg.sanitize`` and ``REPRO_SANITIZE`` (any value but ""
  and "0") turn it on in the port as in the reference.
- Every catalog scenario on `nezha-vectorized`, sanitized, on the CPU: bit
  for bit the unsanitized port run (result and commit trace), and the
  reference's verdict and epoch count on its sanitized numpy tier; a
  16-epoch-window run and `nezha-sharded` (sequential with pre-stamped
  multi-op deadlines, and batched) sanitized likewise.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.engine import DomEngine as RefEngine
from repro.core.engine import EpochState as RefEpochState
from repro.core.sanitizer import SanitizerError as RefSanitizerError
from repro.core.sanitizer import SanitizerTier
from repro.core.vectorized_cluster import VectorizedConfig as RefConfig
from repro.sim import scenario as RS
from repro.sim.network import CloudNetwork as RefNetwork
from repro_torch.core import make_cluster
from repro_torch.core.engine import DomEngine, EpochState
from repro_torch.core.sanitizer import Sanitizer, SanitizerError
from repro_torch.core.sharded import ShardedConfig
from repro_torch.core.vectorized_cluster import config_from_reference
from repro_torch.sim import scenario as PS
from repro_torch.sim import trace as PT
from repro_torch.sim.network import CloudNetwork
from repro_torch.sim.workload import Workload, WorkloadDriver

PROTOCOL = "nezha-vectorized"
_N, _R = 3, 3


# ---------------------------------------------------------------------------
# tampered states: the reference's verdicts and violation lists
# ---------------------------------------------------------------------------
def _clean() -> dict:
    """The reference tests' invariant-clean post-stage state (3 entries x
    3 replicas, everything admitted and committed on the fast path)."""
    d = np.array([1.0, 2.0, 3.0])
    arrivals = np.tile(d[:, None], (1, _R)) - 0.5
    return dict(
        t=np.zeros(_N), t0=np.zeros(_N), cid=np.arange(_N),
        rid=np.zeros(_N, np.int64), kcls=None,
        alive=np.ones(_R, bool), leader=0,
        deadlines=d, arrivals=arrivals,
        admitted=np.ones((_N, _R), bool),
        release=np.maximum(d[:, None], arrivals),
        commit_time=d + 0.1, fast=np.ones(_N, bool),
        committed=np.ones(_N, bool))


def _nan(k):
    k["deadlines"][0] = np.nan


def _dead_admits(k):
    k["alive"][2] = False


def _no_arrival(k):
    k["arrivals"][0, 0] = np.inf


def _held(k):
    k["release"][1, 1] += 0.5


def _floor(k):
    k["release_floor"] = 2.0


def _late_admitted(k):
    k["arrivals"][0, 0] = 5.0
    k["release"][0, 0] = 5.0


def _commit_masks(k):
    k["commit_time"][0] = np.inf
    k["committed"][1] = False
    k["commit_time"][1] = np.inf


def _capped(k):
    k["arrivals"][2, 0] = 1.0
    k["release"][2, 0] = 1.0


def _clock_frames(k, err=0.0):
    off = np.zeros((_N, _R))
    off[:, 1] = 3e-4
    k["clock_arr_off"] = off
    k["release"] = np.maximum(k["deadlines"][:, None],
                              k["arrivals"] + off) - off
    k["release"][0, 1] += err


def _prestamped(k, drift=0.0):
    k["pre_deadline"] = np.array([1.0, 0.0, 3.0])
    k["deadlines"][0] += drift


TAMPERED = {
    "clean": (None, 0.0),
    "nan-deadline": (_nan, 0.0),
    "dead-replica-admits": (_dead_admits, 0.0),
    "admitted-without-arrival": (_no_arrival, 0.0),
    "release-not-watermark": (_held, 0.0),
    "release-below-floor": (_floor, 0.0),
    "release-order-breaks-deadline-order": (_late_admitted, 0.0),
    "commit-masks": (_commit_masks, 0.0),
    "capped-leader-without-cap": (_capped, 0.0),
    "capped-leader-exempt": (_capped, 0.4),
    "clock-offsets-local-frame": (_clock_frames, 0.0),
    "clock-offsets-held": (lambda k: _clock_frames(k, 1e-3), 0.0),
    "prestamped-kept": (_prestamped, 0.0),
    "prestamped-drifted": (lambda k: _prestamped(k, 1e-9), 0.0),
}


def _verdict(state_cls, sanitizer, error, tamper, cap):
    kw = _clean()
    if tamper is not None:
        tamper(kw)
    s = state_cls(**kw)
    eng = SimpleNamespace(cfg=SimpleNamespace(deadline_cap=cap))
    try:
        sanitizer.check_epoch(s, eng)
        msg = None
    except error as exc:
        msg = str(exc)
    return msg, list(sanitizer.violations), sanitizer.epochs_checked


@pytest.mark.parametrize("case", TAMPERED)
def test_tampered_state_gets_the_references_verdict(case):
    tamper, cap = TAMPERED[case]
    ref = _verdict(RefEpochState, SanitizerTier("numpy"), RefSanitizerError,
                   tamper, cap)
    port = _verdict(EpochState, Sanitizer("torch-cpu"), SanitizerError,
                    tamper, cap)
    assert port[1:] == ref[1:]
    if ref[0] is None:
        assert port[0] is None
    else:
        assert port[0] == ref[0].replace("[tier=numpy,", "[tier=torch-cpu,")
    assert (ref[0] is None) == (case in ("clean", "capped-leader-exempt",
                                         "clock-offsets-local-frame",
                                         "prestamped-kept"))


def test_sanitizer_error_is_an_assertion_error():
    assert issubclass(SanitizerError, AssertionError)
    assert not issubclass(SanitizerError, RefSanitizerError)


# ---------------------------------------------------------------------------
# the switches: cfg.sanitize and REPRO_SANITIZE
# ---------------------------------------------------------------------------
def _both_engines(**cfg_kw):
    rc = RefConfig(f=1, **cfg_kw)
    cfg = config_from_reference(dataclasses.asdict(rc), device="cpu")
    ref = RefEngine(rc, RefNetwork(5, rc.net, seed=0), 3, tier="numpy")
    port = DomEngine(cfg, CloudNetwork(5, cfg.net, seed=0), 3)
    return ref, port


@pytest.mark.parametrize("sanitize", [True, False])
def test_sanitizer_is_switched_by_the_config(monkeypatch, sanitize):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    ref, port = _both_engines(sanitize=sanitize)
    assert isinstance(ref.tier, SanitizerTier) == sanitize
    assert (port.sanitizer is not None) == sanitize
    if sanitize:
        assert isinstance(port.sanitizer, Sanitizer)
        assert port.sanitizer.name == port.tier_name == "torch-cpu"


@pytest.mark.parametrize("value,on", [("1", True), ("yes", True),
                                      ("0", False), ("", False)])
def test_sanitize_variable_switches_the_sanitizer(monkeypatch, value, on):
    """`REPRO_SANITIZE` switches the sanitizer on as ``cfg.sanitize`` does,
    for any value but "" and "0" -- in both packages."""
    monkeypatch.setenv("REPRO_SANITIZE", value)
    ref, port = _both_engines()
    assert isinstance(ref.tier, SanitizerTier) == on
    assert (port.sanitizer is not None) == on


# ---------------------------------------------------------------------------
# sanitized runs: bit for bit, and the reference's verdict
# ---------------------------------------------------------------------------
def _sanitized(sc):
    return dataclasses.replace(sc, overrides={**sc.overrides,
                                              "sanitize": True})


def _same(a, b, where=""):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for key in a:
            _same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert a == b and type(a) is type(b), (where, a, b)


TRACE_PARTS = ("log", "commits", "stamps", "sync", "durability",
               "replica_logs", "net_windows", "order_scope")


def _assert_runs_equal(plain, sanitized):
    (r0, c0), (r1, c1) = plain, sanitized
    for key in PS.SCENARIO_RESULT_KEYS:
        _same(getattr(r1, key), getattr(r0, key), key)
    _same(r1.raw, r0.raw, "raw")
    t0, t1 = PT.CommitTrace.from_cluster(c0), PT.CommitTrace.from_cluster(c1)
    for part in TRACE_PARTS:
        _same(getattr(t1, part), getattr(t0, part), part)


@pytest.mark.parametrize("name", RS.available_scenarios())
def test_sanitized_scenario_is_bit_for_bit_with_the_references_verdict(
        monkeypatch, name):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    sc = PS.get_scenario(name)
    plain = PS.run_scenario_on_cluster(PROTOCOL, sc, device="cpu")
    assert plain[1].engine.sanitizer is None
    try:
        res, cl = PS.run_scenario_on_cluster(PROTOCOL, _sanitized(sc),
                                             device="cpu")
        port = None
    except SanitizerError as exc:
        port = str(exc)
    try:
        _, rcl = RS.run_scenario_on_cluster(
            PROTOCOL, _sanitized(RS.get_scenario(name)), tier="numpy")
        ref = None
    except RefSanitizerError as exc:
        ref = str(exc)
    assert port == (None if ref is None else
                    ref.replace("[tier=numpy,", "[tier=torch-cpu,"))
    if ref is None:
        san = cl.engine.sanitizer
        assert san.violations == [] and san.name == "torch-cpu"
        assert san.epochs_checked == rcl.engine.tier.epochs_checked > 0
        _assert_runs_equal(plain, (res, cl))


def test_sanitized_16_epoch_windows_are_bit_for_bit(monkeypatch):
    """`leader-crash` at `epochs_per_dispatch` 16 (retry-closed windows on
    both sides of the crash), sanitized and not: every window's epochs are
    checked after their Deliver/Log, and nothing changes."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    windows = []
    run_window = DomEngine.run_window

    def counted(self, *a, **k):
        windows.append(len(a[0]))
        return run_window(self, *a, **k)

    monkeypatch.setattr(DomEngine, "run_window", counted)
    runs = []
    for sanitize in (False, True):
        cfg = dataclasses.replace(PS.build_config(PROTOCOL, "leader-crash"),
                                  epochs_per_dispatch=16, client_timeout=1.0,
                                  sanitize=sanitize)
        runs.append(PS.run_scenario_on_cluster(PROTOCOL, "leader-crash",
                                               config=cfg, device="cpu"))
    assert 16 in windows and runs[1][0].view_changes == 1
    san = runs[1][1].engine.sanitizer
    assert san.violations == []
    assert san.epochs_checked == runs[1][0].raw["batches"] > 0
    _assert_runs_equal(runs[0], runs[1])


_W_MULTI = Workload(mode="open", rate_per_client=2000.0, duration=0.06,
                    warmup=0.02, drain=0.06, multiop_ratio=0.15,
                    multiop_span=3, seed=3)


def test_sharded_sanitizer_checks_prestamped_deadlines():
    """The reference's sharded case (tests/test_sharded.py:342-365): a
    sanitized G 4 run with multi-key operations (pre-stamped global
    deadlines) is clean, and a state whose stamped deadline drifted off
    its pre-stamped value is caught."""
    cl = make_cluster("nezha-sharded", ShardedConfig(groups=4, sanitize=True,
                                                     device="cpu"))
    WorkloadDriver(_W_MULTI).run(cl)
    san = cl.groups[0].engine.sanitizer
    assert san.epochs_checked > 0 and san.violations == []
    s = EpochState(t=np.array([0.01]), t0=np.array([0.01]),
                   cid=np.array([0]), rid=np.array([0]), kcls=None,
                   alive=np.ones(3, bool), leader=0)
    s.deadlines = np.array([0.0125 + 1e-9])
    s.pre_deadline = np.array([0.0125])
    s.commit_time = np.array([np.inf])
    s.committed = np.array([False])
    s.fast = np.array([False])
    with pytest.raises(SanitizerError, match="pre-stamped"):
        san.check_epoch(s, cl.groups[0].engine)


def test_sharded_batched_epochs_are_checked_and_unchanged():
    """`nezha-sharded` at G 4 on the batched path (`vmap_groups`): each
    group's epochs are checked after the batched epoch's Deliver/Log, and
    the sanitized run equals the unsanitized one bit for bit."""
    w = Workload(mode="open", rate_per_client=2000.0, duration=0.08,
                 warmup=0.02, drain=0.06, seed=1)
    out = []
    for sanitize in (False, True):
        cl = make_cluster("nezha-sharded", ShardedConfig(
            groups=4, sanitize=sanitize, vmap_groups=True, device="cpu"))
        out.append((WorkloadDriver(w).run(cl), cl))
    (s0, c0), (s1, c1) = out
    assert c1.summary()["vmap_epochs"] > 0
    _same(s1, s0, "summary")
    _same(c1._merged_latencies(), c0._merged_latencies(), "latencies")
    checked = [g.engine.sanitizer.epochs_checked for g in c1.groups]
    assert all(n > 0 for n in checked)
    assert all(g.engine.sanitizer.violations == [] for g in c1.groups)
    assert all(g.engine.sanitizer is None for g in c0.groups)
