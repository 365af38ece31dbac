"""The slice end to end: the port's `nezha-vectorized` cluster (on the CPU)
against the reference's `nezha-vectorized` numpy tier, built from the same
configuration (through `config_from_reference`) and driven by the same
workload seed.

Tolerance: bit for bit -- every numeric key of ``summary()`` (not
``tier``/``backend``), every commit latency, the per-request commit trace
(client-side commit times, uids, fast flags) and the replica log columns.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import make_cluster as ref_make_cluster
from repro.core.vectorized_cluster import VectorizedConfig as RefConfig
from repro.sim.network import NetworkParams as RefNetworkParams
from repro.sim.workload import Workload as RefWorkload
from repro.sim.workload import WorkloadDriver as RefDriver
from repro_torch.core import (
    SUMMARY_REQUIRED_KEYS,
    CommonConfig,
    VectorizedConfig,
    available_clusters,
    config_from_reference,
    make_cluster,
)
from repro_torch.core.engine import DomEngine
from repro_torch.sim.workload import Workload, WorkloadDriver, route_keys

WORK = dict(mode="open", rate_per_client=5000.0, duration=0.12,
            read_ratio=0.5, skew=0.5, n_keys=1_000_000, seed=5)


def _run_pair(cfg_kw, crash=None, monkeypatch=None):
    rc = RefConfig(f=1, n_clients=4, seed=3, **cfg_kw)
    ref = ref_make_cluster("nezha-vectorized", rc)
    cfg = config_from_reference(dataclasses.asdict(rc), device="cpu")
    port = make_cluster("nezha-vectorized", cfg)
    windows = []
    if monkeypatch is not None:
        run_window = DomEngine.run_window

        def counted(self, *a, **k):
            windows.append(len(a[0]))
            return run_window(self, *a, **k)

        monkeypatch.setattr(DomEngine, "run_window", counted)
    for cl, W, D in ((ref, RefWorkload, RefDriver),
                     (port, Workload, WorkloadDriver)):
        w = W(**WORK)
        cl.start()
        D(w).inject_open_loop(cl)
        if crash is not None:
            cl.crash_at(crash, 0)
        cl.run_for(w.duration + w.drain)
    return ref, port, windows


def _assert_bitwise_equal(ref, port):
    a, b = ref.summary(), port.summary()
    assert set(a) == set(b)
    for key in a:
        if key in ("tier", "backend"):
            continue
        assert a[key] == b[key] or (np.isnan(a[key]) and np.isnan(b[key])), key
    assert b["tier"] == "torch-cpu" and b["backend"] == "vectorized"
    assert np.concatenate(ref._latencies).tobytes() == \
        np.concatenate(port._latencies).tobytes()
    assert len(ref._trace_commits) == len(port._trace_commits)
    for x, y in zip(ref._trace_commits, port._trace_commits):
        for cx, cy in zip(x, y):            # commit times, cid, rid, fast, rec
            assert np.asarray(cx).tobytes() == np.asarray(cy).tobytes()
    la, lb = ref.engine.logs.log_columns(), port.engine.logs.log_columns()
    assert set(la) == set(lb)
    for col in la:
        assert la[col].tobytes() == lb[col].tobytes(), col
    assert ref.epoch_leaders == port.epoch_leaders
    np.testing.assert_array_equal(ref.engine.owd_pool, port.engine.owd_pool)


def test_fault_free_single_epochs_match_reference_bitwise():
    """Run (a): fault-free, one epoch per dispatch."""
    ref, port, _ = _run_pair({})
    assert port.summary()["committed"] > 500
    _assert_bitwise_equal(ref, port)


def test_fault_free_16_epoch_windows_match_reference_bitwise(monkeypatch):
    """Run (b): fault-free with ``epochs_per_dispatch=16``; a long client
    timeout keeps the windows retry-closed, so the window path runs."""
    ref, port, windows = _run_pair(
        {"epochs_per_dispatch": 16, "client_timeout": 1.0},
        monkeypatch=monkeypatch)
    assert 16 in windows
    _assert_bitwise_equal(ref, port)


def test_leader_crash_view_change_and_merge_log_match_reference_bitwise():
    """Run (c): the leader crashes mid-run on a lossy fabric, so detection,
    the view change and MERGE-LOG all run (entries are recovered and
    dropped), and the 16-epoch windows resume after recovery."""
    lossy = dataclasses.asdict(RefNetworkParams(drop_prob=0.05))
    ref, port, _ = _run_pair({"epochs_per_dispatch": 16,
                              "net": RefNetworkParams(**lossy)},
                             crash=0.053)
    s = port.summary()
    assert s["view_changes"] == 1
    assert s["recovered_entries"] + s["dropped_speculative"] > 0
    assert port.view_change_events[0]["leader"] == 1
    _assert_bitwise_equal(ref, port)


def test_relaunch_and_second_crash_match_reference_bitwise():
    """Crash, relaunch, then a second leader crash: the view-change pipeline
    escalates past the relaunched replica exactly like the reference."""
    rc = RefConfig(f=1, n_clients=2, seed=8)
    ref = ref_make_cluster("nezha-vectorized", rc)
    port = make_cluster("nezha-vectorized",
                        config_from_reference(dataclasses.asdict(rc),
                                              device="cpu"))
    for cl, W, D in ((ref, RefWorkload, RefDriver),
                     (port, Workload, WorkloadDriver)):
        w = W(**{**WORK, "duration": 0.2})
        D(w).inject_open_loop(cl)
        cl.crash_at(0.04, 0)
        cl.relaunch_at(0.09, 0)
        cl.crash_at(0.13, 1)
        cl.run_for(0.3)
    assert port.summary()["view_changes"] >= 2
    _assert_bitwise_equal(ref, port)


def test_config_from_reference_round_trips_every_field():
    rc = RefConfig(f=2, n_clients=3, seed=11, epochs_per_dispatch=4,
                   deadline_cap=1e-3, tier="jit")
    cfg = config_from_reference(dataclasses.asdict(rc), device="cpu")
    assert isinstance(cfg, VectorizedConfig) and cfg.device == "cpu"
    mine = dataclasses.asdict(cfg)
    theirs = dataclasses.asdict(rc)
    for key, value in theirs.items():
        if key == "tier":
            assert key not in mine
        else:
            assert mine[key] == value, key


def test_registry_and_summary_schema():
    from repro_torch.core.registry import _coerce_config

    assert available_clusters() == (
        "nezha", "nezha-nonproxy", "nezha-vectorized", "nezha-sharded",
        "multipaxos", "raft", "fastpaxos", "nopaxos", "nopaxos-optim",
        "domino", "toq-epaxos", "unreplicated")
    promoted = _coerce_config(CommonConfig(f=2, n_clients=5),
                              VectorizedConfig)
    assert isinstance(promoted, VectorizedConfig)
    assert (promoted.f, promoted.n_clients) == (2, 5)
    cfg = VectorizedConfig(f=1, n_clients=2, seed=1, device="cpu")
    cl = make_cluster("nezha-vectorized", cfg)
    s = WorkloadDriver(Workload(rate_per_client=2000.0, duration=0.05,
                                seed=1)).run(cl)
    assert SUMMARY_REQUIRED_KEYS <= set(s)
    assert s["committed"] > 0 and s["throughput"] > 0
    with pytest.raises(KeyError):
        make_cluster("nezha-vectorized-jit", cfg)


def test_closed_loop_matches_reference_bitwise():
    rc = RefConfig(f=1, n_clients=3, seed=2)
    ref = ref_make_cluster("nezha-vectorized", rc)
    port = make_cluster("nezha-vectorized",
                        config_from_reference(dataclasses.asdict(rc),
                                              device="cpu"))
    sa = RefDriver(RefWorkload(mode="closed", duration=0.05, lanes=4,
                               seed=3)).run(ref)
    sb = WorkloadDriver(Workload(mode="closed", duration=0.05, lanes=4,
                                 seed=3)).run(port)
    for key in sa:
        if key not in ("tier", "backend"):
            assert sa[key] == sb[key], key
    _assert_bitwise_equal(ref, port)


def test_route_keys_matches_reference():
    from repro.sim.workload import route_keys as ref_route_keys

    keys = np.random.default_rng(0).integers(0, 2**40, 1000)
    for g in (1, 4, 16):
        np.testing.assert_array_equal(route_keys(keys, g),
                                      ref_route_keys(keys, g))


def test_cuda_device_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_cluster("nezha-vectorized", VectorizedConfig(f=1))
