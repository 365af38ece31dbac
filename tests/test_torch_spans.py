"""The tracer of `repro_torch.core.spans` inside the epoch loop, on the CPU.

Tracing on against off: tiny deployments on the per-epoch crash/relaunch
path, the K-epoch window path, and the sharded backend batched and group
by group, each run with and without `spans.recording()`, must leave the
same summary, latencies, commit trace, replica logs, view changes and
epoch leaders, bit for bit. Under a CPU-only `torch.profiler` the tracer
records between `start()` and `stop()` and nowhere else.

Counters against counts made independently of the tracer: body dispatches
against a test-local wrapper of `DomEngine._body`, retry generations
against the rows the retry model re-enqueues, abandonments against the
inf latencies, completed view changes against the rise of
``summary()["view_changes"]``, and the window share on a fault-free
window-path run.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import (
    ShardedConfig,
    VectorizedConfig,
    make_cluster,
    spans,
)
from repro_torch.core.engine import DomEngine, PendingBuffer
from repro_torch.sim.network import NetworkParams
from repro_torch.sim.trace import CommitTrace
from repro_torch.sim.workload import Workload, WorkloadDriver

WORK = dict(mode="open", rate_per_client=5000.0, duration=0.12,
            read_ratio=0.5, skew=0.5, n_keys=1_000_000, seed=5)


@pytest.fixture(autouse=True)
def clean_tracer():
    spans.reset()
    yield
    spans.reset()


def _inject(cl, **work):
    cl.start()
    WorkloadDriver(Workload(**{**WORK, **work})).inject_open_loop(cl)


def per_epoch_crash():
    """One epoch a dispatch on a lossy fabric; the leader crashes, is
    relaunched, and the next leader crashes: two view changes, MERGE-LOG,
    client retries."""
    cl = make_cluster("nezha-vectorized", VectorizedConfig(
        f=1, n_clients=4, seed=3, device="cpu",
        net=NetworkParams(drop_prob=0.05)))
    _inject(cl, duration=0.2)
    cl.crash_at(0.04, 0)
    cl.relaunch_at(0.09, 0)
    cl.crash_at(0.13, 1)
    return cl, 0.35


def window_path():
    """Fault-free 16-epoch windows (a long client timeout keeps them
    retry-closed)."""
    cl = make_cluster("nezha-vectorized", VectorizedConfig(
        f=1, n_clients=4, seed=3, device="cpu", epochs_per_dispatch=16,
        client_timeout=1.0))
    _inject(cl, duration=0.3)
    return cl, 0.64


def window_then_crash():
    """16-epoch windows around a leader crash: window epochs, per-epoch
    epochs and a view change in one run."""
    cl = make_cluster("nezha-vectorized", VectorizedConfig(
        f=1, n_clients=4, seed=3, device="cpu", epochs_per_dispatch=16,
        net=NetworkParams(drop_prob=0.05)))
    _inject(cl, duration=0.25)
    cl.crash_at(0.053, 0)
    return cl, 0.5


def outage():
    """Two of three replicas down for a while: the view change cannot
    complete, clients retry until they give up (two retries each)."""
    cl = make_cluster("nezha-vectorized", VectorizedConfig(
        f=1, n_clients=4, seed=3, device="cpu", max_retries=2))
    _inject(cl, duration=0.15)
    cl.crash_at(0.03, 0)
    cl.crash_at(0.03, 1)
    cl.relaunch_at(0.12, 0)
    return cl, 0.4


def sharded_batched():
    """Four groups, single-key requests: every epoch batched over G."""
    cl = make_cluster("nezha-sharded", ShardedConfig(
        groups=4, f=1, n_clients=8, seed=2, device="cpu", vmap_groups=True))
    _inject(cl, rate_per_client=3000.0, duration=0.1)
    return cl, 0.2


def sharded_groupwise():
    """Four groups with cross-group ops: pre-stamped entries send the
    epochs group by group."""
    cl = make_cluster("nezha-sharded", ShardedConfig(
        groups=4, f=1, n_clients=8, seed=2, device="cpu", vmap_groups=True))
    _inject(cl, rate_per_client=3000.0, duration=0.1, multiop_ratio=0.2,
            multiop_span=3)
    return cl, 0.2


DEPLOYMENTS = [per_epoch_crash, window_path, window_then_crash, outage,
               sharded_batched, sharded_groupwise]


def _run(deployment, record: bool):
    cl, duration = deployment()
    with spans.recording() if record else contextlib.nullcontext():
        cl.run_for(duration)
    return cl


def _canon(x):
    """A value as bytes and plain types, so that == is bit for bit (nan
    included)."""
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, (float, np.floating, np.ndarray)):
        a = np.asarray(x)
        return (a.dtype.str, a.shape, a.tobytes())
    return x


def _group_state(g) -> dict:
    return {"latencies": [np.asarray(x) for x in g._latencies],
            "trace_commits": g._trace_commits,
            "log": g.engine.logs.log_columns(),
            "replica_logs": g.engine.logs.replica_log_columns(),
            "spec": (g.engine.logs.spec_deadline, g.engine.logs.spec_cid,
                     g.engine.logs.spec_rid, g.engine.logs.spec_admitted),
            "view_changes": g.view_change_events,
            "leaders": g.epoch_leaders, "owd_pool": g.engine.owd_pool,
            "pending": g._pending._buf[:len(g._pending)]}


def _state(cl) -> dict:
    out = {"summary": cl.summary()}
    trace = CommitTrace.from_cluster(cl)
    if cl.backend == "sharded":
        out["groups"] = [_group_state(g) for g in cl.groups]
        out["merged"] = cl._merged_latencies()
        out["trace"] = [(g.log, g.commits) for g in trace.groups]
        out["multiops"] = trace.multiops
    else:
        out.update(_group_state(cl))
        out["trace"] = (trace.log, trace.commits)
    return _canon(out)


@pytest.mark.parametrize("deployment", DEPLOYMENTS,
                         ids=[d.__name__ for d in DEPLOYMENTS])
def test_tracing_on_and_off_agree_bit_for_bit(deployment):
    off = _run(deployment, record=False)
    assert spans.snapshot()["counts"] == {}     # nothing recorded when off
    on = _run(deployment, record=True)
    snap = spans.snapshot()
    assert snap["counts"]["body_dispatches"] > 0
    # (the batched sharded loop runs no view-change check)
    assert {"sample", "dispatch", "deliver_log", "absorb", "pop_due"} \
        <= set(snap["seconds"])
    assert _state(on) == _state(off)
    assert on.summary()["committed"] > 100


def test_the_paths_each_deployment_exercises():
    """The deployments reach the paths their names claim."""
    seen = {}
    for dep in DEPLOYMENTS:
        spans.reset()
        cl = _run(dep, record=True)
        seen[dep.__name__] = (spans.snapshot()["counts"], cl.summary())
    c, s = seen["per_epoch_crash"]
    assert s["view_changes"] >= 2 and c.get("epochs_window", 0) == 0
    assert c.get("epochs_single", 0) > 0
    c, s = seen["window_then_crash"]
    assert c["epochs_window"] > 0 and c["epochs_single"] > 0
    assert s["view_changes"] == 1
    c, s = seen["outage"]
    assert c["given_up"] > 0
    c, s = seen["sharded_batched"]
    assert s["vmap_epochs"] > 0 and s["cross_group_ops"] == 0
    c, s = seen["sharded_groupwise"]
    assert s["cross_group_ops"] > 0 and c["epochs_single"] > 0


def test_records_only_while_a_profiler_records():
    """The tracer records between the profiler's start() and stop(): not
    before, not after. Its host-only spans enter the trace as nezha.*
    ranges; the dispatch span, which encloses device work, does not. The
    results equal an untraced run's."""
    plain, _ = window_then_crash()
    for d in (0.1, 0.2, 0.2):
        plain.run_for(d)
    cl, _ = window_then_crash()
    cl.run_for(0.1)
    assert spans.snapshot() == {"seconds": {}, "calls": {}, "counts": {},
                                "dispatches": []}
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    cl.run_for(0.2)
    prof.stop()
    snap = spans.snapshot()
    assert snap["counts"]["body_dispatches"] > 0
    assert {"sample", "dispatch", "deliver_log", "absorb",
            "viewchange"} <= set(snap["seconds"])
    cl.run_for(0.2)
    assert spans.snapshot() == snap
    names = {e.name for e in prof.events()}
    assert {"nezha.sample", "nezha.deliver_log", "nezha.absorb",
            "nezha.viewchange", "nezha.pop_due"} <= names
    assert "nezha.dispatch" not in names
    assert _state(cl) == _state(plain)


def test_gc_pauses_are_timed_only_while_recording():
    import gc

    gc.collect()
    assert "gc" not in spans.snapshot()["seconds"]
    with spans.recording():
        gc.collect()
        gc.collect()
    snap = spans.snapshot()
    assert snap["calls"]["gc"] >= 2 and snap["seconds"]["gc"] > 0.0
    gc.collect()
    assert spans.snapshot()["calls"]["gc"] == snap["calls"]["gc"]


def test_gc_pauses_enter_the_profiler_trace():
    import gc

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    gc.collect()
    prof.stop()
    assert spans.snapshot()["calls"]["gc"] >= 1
    assert "nezha.gc" in {e.name for e in prof.events()}


@pytest.mark.parametrize("deployment", DEPLOYMENTS,
                         ids=[d.__name__ for d in DEPLOYMENTS])
def test_body_dispatches_match_a_wrapper_of_the_body(deployment,
                                                     monkeypatch):
    """body_dispatches, lanes_valid, lanes_padded and the per-dispatch
    pairs against a test-local wrapper of `DomEngine._body` (the old
    probe's method, kept here only)."""
    seen = []
    make_body = DomEngine._body

    def probed(self, use_kcls, use_cap):
        body = make_body(self, use_kcls, use_cap)

        def run(*args, **kw):
            # args[11]: the valid lanes of each group; args[3]: t [G, n_pad]
            seen.append(([int(n) for n in args[11]], args[3].shape))
            return body(*args, **kw)
        return run

    monkeypatch.setattr(DomEngine, "_body", probed)
    _run(deployment, record=True)
    snap = spans.snapshot()
    c = snap["counts"]
    assert c["body_dispatches"] == len(seen) > 0
    assert c["lanes_valid"] == sum(sum(v) for v, _ in seen)
    assert c["lanes_padded"] == sum(g * n for _, (g, n) in seen)
    assert snap["dispatches"] == [(max(v), n) for v, (_, n) in seen]
    assert 0 < c["lanes_valid"] <= c["lanes_padded"]


@pytest.mark.parametrize("deployment", [per_epoch_crash, outage,
                                        window_then_crash])
def test_retry_generations_sum_to_the_reissued_attempts(deployment,
                                                        monkeypatch):
    """The retry_gen_<k> counts sum to the rows the retry model puts back
    into the pending buffer (`PendingBuffer.extend` is its only caller),
    each k lies in 1..max_retries, and given_up equals the inf latencies
    (the abandoned requests)."""
    rows = []
    extend = PendingBuffer.extend

    def counted(self, r):
        rows.append(r.size)
        return extend(self, r)

    monkeypatch.setattr(PendingBuffer, "extend", counted)
    cl = _run(deployment, record=True)
    c = spans.snapshot()["counts"]
    gens = {int(k[len("retry_gen_"):]): n for k, n in c.items()
            if k.startswith("retry_gen_")}
    assert sum(gens.values()) == sum(rows) > 0
    assert set(gens) <= set(range(1, cl.cfg.max_retries + 1))
    inf = int(np.isinf(np.concatenate(cl._latencies)).sum())
    assert c.get("given_up", 0) == inf
    if deployment is outage:
        assert inf > 0 and max(gens) == cl.cfg.max_retries


@pytest.mark.parametrize("deployment", [per_epoch_crash, window_then_crash])
def test_viewchanges_done_is_the_rise_in_view_changes(deployment):
    cl, duration = deployment()
    before = cl.summary()["view_changes"]
    with spans.recording():
        cl.run_for(duration)
    assert cl._vc is None                   # none left in flight
    rise = cl.summary()["view_changes"] - before
    assert spans.snapshot()["counts"]["viewchanges_done"] == rise > 0
    assert rise == len(cl.view_change_events)


def test_window_share_is_whole_on_a_fault_free_window_run():
    cl = _run(window_path, record=True)
    c = spans.snapshot()["counts"]
    assert c["epochs_window"] > 0 and c.get("epochs_single", 0) == 0
    assert c["epochs_window"] == cl.summary()["batches"]


def test_recording_nests():
    with spans.recording():
        with spans.recording():
            spans.count("x")
        spans.count("x")
    spans.count("x")
    assert spans.snapshot()["counts"] == {"x": 2}
    assert not spans.on()

