"""The per-layer metrics that read the program's own spans and counters
(`repro_torch.core.spans`, through `harness/spans.py`): each reads a
snapshot taken under `recording()`, and returns None on an empty one and
on a program without the tracer."""
import sys

import numpy as np
import pytest

from bench_tiny import ROOT

from harness.spec import Spec

METRICS = ("sample_us_per_req", "dispatch_us_per_req",
           "deliver_log_us_per_req", "absorb_us_per_req",
           "viewchange_host_ms", "body_dispatches_per_kreq",
           "dispatch_lane_fill", "window_epoch_share", "retries_per_kreq",
           "pop_due_us_per_req", "gc_pause_share")


@pytest.fixture
def tracer():
    from repro_torch.core import spans

    spans.reset()
    yield spans
    spans.reset()


def _recorded_run(spans) -> dict:
    """A tiny deployment with 16-epoch windows, a lossy fabric and a
    leader crash, run under `recording()`; its records as the harness
    gives them to a metric."""
    import gc
    import time

    from repro_torch.core import VectorizedConfig, make_cluster
    from repro_torch.sim.network import NetworkParams
    from repro_torch.sim.workload import Workload, WorkloadDriver

    cl = make_cluster("nezha-vectorized", VectorizedConfig(
        f=1, n_clients=4, seed=3, device="cpu", epochs_per_dispatch=16,
        net=NetworkParams(drop_prob=0.05)))
    WorkloadDriver(Workload(mode="open", rate_per_client=5000.0,
                            duration=0.25, seed=5)).inject_open_loop(cl)
    cl.crash_at(0.053, 0)
    t0 = time.perf_counter()
    with spans.recording():
        cl.run_for(0.5)
        gc.collect()
    return {"committed": cl.summary()["committed"],
            "traced_window_s": time.perf_counter() - t0}


def _reader(name):
    return Spec(ROOT).metric_reader(name)


def test_every_metric_is_declared_with_its_module():
    spec = Spec(ROOT)
    declared = {m["name"]: m for m in spec.bench["per_layer"]}
    for name in METRICS:
        mod, entry = _reader(name), declared[name]
        assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.BETTER, mod.MOVES) == (
            entry["layer"], entry["source"], entry["unit"], entry["better"],
            entry["moves"])


@pytest.mark.parametrize("name", METRICS)
def test_reads_a_recorded_snapshot(name, tracer):
    rec = _recorded_run(tracer)
    value = _reader(name).read(rec)
    assert value is not None and np.isfinite(value) and value >= 0.0
    snap = tracer.snapshot()
    c, sec = snap["counts"], snap["seconds"]
    n = rec["committed"]
    want = {
        "sample_us_per_req": sec["sample"] / n * 1e6,
        "dispatch_us_per_req": sec["dispatch"] / n * 1e6,
        "deliver_log_us_per_req": sec["deliver_log"] / n * 1e6,
        "absorb_us_per_req": sec["absorb"] / n * 1e6,
        "pop_due_us_per_req": sec["pop_due"] / n * 1e6,
        "viewchange_host_ms": sec["viewchange"] / c["viewchanges_done"]
        * 1e3,
        "body_dispatches_per_kreq": c["body_dispatches"] / n * 1e3,
        "dispatch_lane_fill": c["lanes_valid"] / c["lanes_padded"] * 100,
        "window_epoch_share": c["epochs_window"]
        / (c["epochs_window"] + c["epochs_single"]) * 100,
        "retries_per_kreq": sum(v for k, v in c.items()
                                if k.startswith("retry_gen_")) / n * 1e3,
        "gc_pause_share": sec["gc"] / rec["traced_window_s"] * 100,
    }[name]
    assert value == pytest.approx(want, rel=1e-12)
    if name in ("dispatch_lane_fill", "window_epoch_share",
                "gc_pause_share"):
        assert 0.0 < value <= 100.0


@pytest.mark.parametrize("name", METRICS)
def test_nothing_recorded_reads_none(name, tracer):
    assert _reader(name).read({"committed": 1000,
                               "traced_window_s": 1.0}) is None


@pytest.mark.parametrize("name", METRICS)
def test_a_program_without_the_tracer_reads_none(name, tracer,
                                                 monkeypatch):
    """What a checkout from before the tracer gives: the import fails and
    the metric is left out of the line, without raising."""
    _recorded_run(tracer)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    monkeypatch.delattr(sys.modules["repro_torch.core"], "spans")
    assert _reader(name).read({"committed": 1000,
                               "traced_window_s": 1.0}) is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_traced_run_on_the_card_reports_the_program_metrics(card):
    """A traced run of the crash cell through the command reports every
    metric of the tracer; one body dispatch launches each DOM kernel once,
    and no span of the program shows among the device's operations."""
    import json
    import subprocess

    done = subprocess.run(
        [sys.executable, "bench/run_cell.py", "--workload",
         "r3-crash-recovery", "--seed", str(2**31 + 5), "--seconds", "6",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert done.returncode == 0, done.stderr[-3000:]
    r = json.loads(done.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(METRICS) <= set(m)
    assert 2 * m["body_dispatches_per_kreq"] == pytest.approx(
        m["dom_launches_per_kreq"], rel=1e-9)
    assert not [n for n, _ in r["breakdown"]["device_ops"]
                if n.startswith("nezha.")]
