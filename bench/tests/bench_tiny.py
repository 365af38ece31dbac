"""Helpers of the benchmark's CPU tests: a copy of the benchmark at a tiny
size (the same files with lower rates and fewer groups) and one run of a
cell on the CPU through the harness."""
from __future__ import annotations

import io
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# rate a client and clients of each cell at the tiny size; the sharded
# deployment runs 8 groups
TINY = {"r3-ycsb-1m": (2000.0, 10), "r3-crash-recovery": (2000.0, 10),
        "g64-ycsb-load": (300.0, 8), "g64-multikey": (300.0, 8)}


def tiny_root(dst: Path) -> Path:
    """BENCHMARK.json and bench/ copied under ``dst`` at the tiny size."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH, dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name, (rate, clients) in TINY.items():
        p = dst / "bench" / "traffic" / f"{name}.json"
        d = json.loads(p.read_text())
        d["rate_per_client"], d["clients"] = rate, clients
        p.write_text(json.dumps(d))
    p = dst / "bench" / "configs" / "nezha-sharded-g64.json"
    d = json.loads(p.read_text())
    d["groups"] = 8
    p.write_text(json.dumps(d))
    return dst


def run_tiny(root: Path, cell: str, seed: int = 7, seconds: float = 0.3,
             trace: bool = False) -> tuple[dict, str, str]:
    """(result, last stdout line, stderr) of one CPU run of ``cell``."""
    from harness.run import emit, run_cell

    out, err = io.StringIO(), io.StringIO()
    result = run_cell(root, cell, seed, seconds, trace, "cpu",
                      time.perf_counter(), err=err)
    emit(result, out=out)
    return result, out.getvalue().strip().splitlines()[-1], err.getvalue()
