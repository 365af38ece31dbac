"""The benchmark's files: BENCHMARK.json against the contract's shape, every
file it names, the configuration and traffic files, and a cell added as
files alone."""
import json
import re

import pytest

from bench_tiny import BENCH, ROOT, tiny_root

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run_cell.py"]
    assert SPEC["paths"] == ["bench"]
    assert all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert {m["name"] for m in SPEC["end_to_end"]} == {"commits_per_s",
                                                       "setup_s"}


def test_names_units_and_text():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"])
    for c in SPEC["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert TEXT.match(m["layer"])
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_named_file_exists_and_is_under_paths():
    cells = {w["name"] for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert c["name"] in {w["config"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    files = [p for p in BENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts]
    assert all(PATH.match(p.relative_to(ROOT).as_posix()) for p in files)


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file_loads(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == name and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"] == []
    assert conf["backend"] in ("nezha-vectorized", "nezha-sharded")
    assert conf["replicas"] == 2 * conf["f"] + 1
    for key in ("n_proxies", "groups", "epoch_duration",
                "epochs_per_dispatch", "commutative", "client_timeout",
                "guarantees", "assumed", "net", "dom"):
        assert key in conf


@pytest.mark.parametrize("cell", [w["traffic"] for w in SPEC["workloads"]])
def test_traffic_file_loads(cell):
    from harness.plan import Plan

    tr = json.loads((BENCH / "traffic" / f"{cell}.json").read_text())
    for key in ("clients", "rate_per_client", "read_share", "keys",
                "multikey_share", "multikey_span", "faults", "chunk_epochs",
                "drain_s", "warmup_epochs"):
        assert key in tr
    conf = json.loads((BENCH / "configs" / "nezha-r3.json").read_text())
    plan = Plan(tr, conf, 2**31 + 11)
    a, b = plan.block(3), plan.block(3)
    assert (a.t == b.t).all() and a.keys == b.keys and a.faults == b.faults
    assert (a.t >= a.t_lo).all() and (a.t < a.t_hi).all()
    assert (a.t[1:] >= a.t[:-1]).all()
    if tr["multikey_share"] > 0:
        multi = [k for k in a.keys if len(k) > 1]
        assert multi and all(len(set(k)) == tr["multikey_span"]
                             for k in multi)


def test_fault_schedule_follows_the_leader():
    from harness.plan import Plan

    tr = json.loads((BENCH / "traffic" / "r3-crash-recovery.json")
                    .read_text())
    conf = json.loads((BENCH / "configs" / "nezha-r3.json").read_text())
    plan = Plan(tr, conf, 1)
    faults = [f for s in range(12) for f in plan.block(s).faults]
    assert faults[:4] == [(0.15, "crash", 0), (0.3, "relaunch", 0),
                          (0.65, "crash", 1), (0.8, "relaunch", 1)]


def test_a_cell_added_as_files_alone_is_listed_and_runs(tmp_path):
    """A new traffic file and a new entry in BENCHMARK.json: no harness
    file changes, and the harness lists and runs the cell."""
    from bench_tiny import run_tiny
    from harness.spec import Spec

    root = tiny_root(tmp_path / "root")
    tr = json.loads((root / "bench/traffic/r3-ycsb-1m.json").read_text())
    tr.update(name="r3-uniform-thin", read_share=0.0,
              keys={"dist": "uniform", "space": 1000})
    (root / "bench/traffic/r3-uniform-thin.json").write_text(json.dumps(tr))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "r3-uniform-thin",
                              "config": "nezha-r3",
                              "traffic": "r3-uniform-thin", "chips": 1,
                              "why": "a throwaway cell"})
    for m in spec["per_layer"]:
        m["workloads"].append("r3-uniform-thin")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert "r3-uniform-thin" in Spec(root).cells()
    result, _, _ = run_tiny(root, "r3-uniform-thin", seconds=0.2)
    assert result["correct"] and result["attempted"] > 0


@pytest.mark.parametrize("change", [{"replicas": 5}, {"groups": 2}])
def test_deployment_that_contradicts_itself_is_refused(change):
    """`replicas` has to be 2f + 1 and `nezha-vectorized` one group: the
    reference reads these keys, so the system may not ignore them."""
    from harness import deploy

    conf = json.loads((BENCH / "configs" / "nezha-r3.json").read_text())
    conf.update(change)
    with pytest.raises(ValueError):
        deploy.make(conf, 2, 1, "cpu")
