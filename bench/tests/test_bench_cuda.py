"""The benchmark on the card: a short run of a cell through the command,
correct, on the GPU, with the device's per-layer metrics in range. Skips
without a card (the decision is made in the fixture)."""
import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(cell: str, seed: int, trace: int) -> dict:
    done = subprocess.run(
        [sys.executable, "bench/run_cell.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["r3-ycsb-1m", "g64-ycsb-load"])
def test_short_run_on_the_card_is_correct(card, cell):
    r = _run(cell, 2**31 + 3, 0)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["metrics"]["commits_per_s"]["value"] > 0


@pytest.mark.cuda
def test_traced_run_reads_the_device(card):
    r = _run("r3-ycsb-1m", 2**31 + 4, 1)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert 0.0 < m["dom_roofline"]["value"] <= 100.0
    assert 0.0 <= m["device_idle_share"]["value"] < 100.0
    assert m["dom_launches_per_kreq"]["value"] > 0.0
    assert 0.0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
