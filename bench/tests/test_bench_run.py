"""A run of each cell end to end on the CPU at a tiny size: the result line,
the comparison beside its limits, the per-layer metrics a CPU run can
read, and the command's refusal without a card."""
import json
import os
import subprocess
import sys

import pytest

from bench_tiny import ROOT, run_tiny, tiny_root

CELLS = ("r3-ycsb-1m", "g64-ycsb-load", "r3-crash-recovery", "g64-multikey")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_and_is_correct(root, cell):
    result, line, err = run_tiny(root, cell, seed=2**31 + 5)
    parsed = json.loads(line)
    assert list(parsed)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(parsed)[-1] == "checks"
    assert parsed["correct"] is True, parsed["checks"]
    assert parsed["attempted"] > 0 and parsed["failed"] == 0
    assert set(parsed["metrics"]) == {"commits_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in parsed["metrics"].values())
    assert parsed["device"]["platform"] == "cpu"
    tail = err.strip().splitlines()[-len(parsed["checks"]):]
    assert all(line.startswith("check ") and "(limit " in line
               for line in tail)


def test_traced_run_reports_the_host_metrics(root):
    result, _, _ = run_tiny(root, "r3-ycsb-1m", trace=True)
    assert result["correct"]
    # a CPU run has no device trace and no kernel counters: those readers
    # return nothing and the metrics are left out
    assert set(result["metrics"]) == {"submit_us_per_req", "run_us_per_req"}
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_the_generator_is_not_timed(root, monkeypatch):
    """A generator that takes 0.2 s a chunk: the window runs its 1 s of
    wall time, and the timed seconds leave the generator's out."""
    import re
    import time

    from harness.plan import Plan

    orig = Plan.block

    def slow(self, span):
        if span:
            time.sleep(0.2)
        return orig(self, span)

    monkeypatch.setattr(Plan, "block", slow)
    _, _, err = run_tiny(root, "r3-ycsb-1m", seconds=1.0)
    chunks, timed, gen = re.search(
        r"window: (\d+) chunks .* in ([0-9.]+) s;.*generate \(not timed\) "
        r"([0-9.]+) s", err).groups()
    assert float(gen) >= 0.2 * int(chunks) >= 0.4
    assert float(timed) + float(gen) >= 1.0
    assert float(timed) < 0.8


def test_same_seed_same_work(root):
    a, _, _ = run_tiny(root, "g64-multikey", seed=99, seconds=1e-6)
    b, _, _ = run_tiny(root, "g64-multikey", seed=99, seconds=1e-6)
    assert a["attempted"] == b["attempted"] > 0


def test_command_refuses_without_a_card():
    """No CUDA here: the command exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    done = subprocess.run(
        [sys.executable, "bench/run_cell.py", "--workload", "r3-ycsb-1m",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
