"""One run of one cell: set-up, the timed window, the drain, the comparison
with the reference, and the result line.

Set-up (``setup_s``, from process start to the first timed call): the DOM
kernels' libraries built or loaded from the checkout's build directory,
the cluster made from the deployment file, and the warm-up span's
requests submitted and run (2 epochs, then the rest of ``warmup_epochs``:
the per-epoch path and one whole window of the window path).

The window repeats, until ``--seconds`` of wall time have passed: make the
next chunk of simulated time (the traffic file's ``chunk_epochs``),
schedule its faults, ``submit_at`` each of its requests (one call a
request: the public path), ``run_for`` the chunk and synchronize.
``commits_per_s`` is the requests committed to their clients during the
window over the window's wall seconds less the ``generate`` span: the
benchmark's own generator runs between the system's calls, while neither
host nor device works for the system, and is not the system's time.

Afterwards, untimed: the speculative tails as the window left them, the
process's peak device memory, a drain of ``drain_s`` of simulated time
with no new requests, the system's results, then the reference's (after
the system's state is freed), and the comparison.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from harness import compare, deploy
from harness.plan import Plan
from harness.spec import Spec

BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of `BANNED`, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in BANNED})


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them (peaks
    and rooflines assume the full 700 W)."""
    import subprocess

    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return done.stdout.strip().splitlines()[0] if done.stdout else "not read"


def _counters() -> int:
    from repro_torch.kernels import dom_admit, dom_release

    return sum(m.launches_small + m.launches_onesweep
               for m in (dom_admit, dom_release))


class _Span:
    """A host-clock span that also marks the profiler's trace."""

    def __init__(self, name: str, acc: dict, traced: bool):
        self.name, self.acc, self.traced = name, acc, traced

    def __enter__(self):
        if self.traced:
            import torch

            self._rf = torch.profiler.record_function("bench." + self.name)
            self._rf.__enter__()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.acc[self.name] = self.acc.get(self.name, 0.0) \
            + time.perf_counter() - self._t
        if self.traced:
            self._rf.__exit__(*exc)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             err=sys.stderr) -> dict:
    import torch

    from repro_torch.core.messages import OpType

    spec = Spec(root)
    cell = spec.cell(workload)
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    plan = Plan(traffic, conf, seed)
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        from repro_torch.kernels import build

        build.library("dom_admit")
        build.library("dom_release")
    cl = deploy.make(conf, traffic["clients"], seed, device)
    log: list = []
    per_client = np.zeros(plan.clients, np.int64)

    def do_block(block, acc, traced):
        log.append(("block", block))
        for t, what, r in block.faults:
            (cl.crash_at if what == "crash" else cl.relaunch_at)(t, r)
        with _Span("submit", acc, traced):
            sub = cl.submit_at
            read, write = OpType.READ, OpType.WRITE
            for t, c, k, rd in zip(block.t.tolist(), block.cid.tolist(),
                                   block.keys, block.read.tolist()):
                sub(t, c, keys=k, op=read if rd else write)
        per_client[:] += np.bincount(block.cid, minlength=plan.clients)

    def do_run(duration, acc, traced):
        log.append(("run", duration))
        with _Span("run_for", acc, traced):
            cl.run_for(duration)
            sync()

    # -- set-up: warm-up span --------------------------------------------------
    log.append(("phase", "warm"))
    ep = plan.epoch
    warm: dict = {}
    do_block(plan.block(0), warm, False)
    do_run(2 * ep, warm, False)
    do_run(plan.warm_s - 2 * ep, warm, False)
    committed0 = deploy.committed_count(cl)
    launches0 = _counters() if cuda else 0
    rids0 = per_client.copy()
    prof = None
    if trace and cuda:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    log.append(("phase", "window"))
    acc: dict = {}
    setup_s = time.perf_counter() - t_start
    # -- the timed window ------------------------------------------------------
    t0 = time.perf_counter()
    span = 1
    while time.perf_counter() - t0 < seconds:
        with _Span("generate", acc, prof is not None):
            block = plan.block(span)
        do_block(block, acc, prof is not None)
        do_run(plan.chunk_s, acc, prof is not None)
        span += 1
    window_s = time.perf_counter() - t0 - acc.get("generate", 0.0)
    if prof is not None:
        prof.stop()
    spec_window = deploy.spec_tails(cl)
    launches1 = _counters() if cuda else 0
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    committed1 = deploy.committed_count(cl)
    # -- drain, results ----------------------------------------------------------
    log.append(("phase", "drain"))
    do_run(float(traffic["drain_s"]), {}, False)
    got = deploy.observation(cl, spec_window)
    del cl
    if cuda:
        torch.cuda.empty_cache()
    from reference import Deployment

    ref = Deployment(conf, plan.clients, seed)
    ref.replay(log)
    want = ref.observation()
    numbers = compare.compare(got, want)
    correct = compare.verdict(numbers)
    done = compare.committed_uids(got)
    window_uids = np.concatenate([
        (np.int64(c) << 32) | np.arange(rids0[c], per_client[c],
                                        dtype=np.int64)
        for c in range(plan.clients)])
    attempted = int(window_uids.size)
    failed = int(np.count_nonzero(~np.isin(window_uids, done)))
    committed = committed1 - committed0
    records = {
        "submit_s": acc.get("submit", 0.0), "run_s": acc.get("run_for", 0.0),
        "submitted": attempted, "committed": committed,
        "launches": launches1 - launches0 if cuda else None,
        "epoch_sizes": ref.epoch_sizes("window"),
        "replicas": 2 * int(conf["f"]) + 1,
    }
    if prof is not None:
        from harness import devtrace

        records.update(devtrace.read(prof))
    # -- the result line ---------------------------------------------------------
    if trace:
        metrics = {}
        for m in spec.per_layer(workload):
            value = spec.metric_reader(m["name"]).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = {"commits_per_s": committed / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in spec.end_to_end(workload)}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = float(records.get("busy_s", 0.0))
        dev["window_s"] = float(records.get("traced_window_s", window_s))
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and "device_ops" in records:
        result["breakdown"] = {"device_ops": records["device_ops"],
                               "idle_gaps": records["idle_gaps"]}
    if cuda:
        result["card"] = card()
    result["checks"] = {k: {"value": v, "limit": compare.LIMITS[k]}
                        for k, v in numbers.items()}
    print(f"window: {span - 1} chunks of {plan.chunk_s} s simulated in "
          f"{window_s:.3f} s; submit {acc.get('submit', 0.0):.3f} s, run_for "
          f"{acc.get('run_for', 0.0):.3f} s; generate (not timed) "
          f"{acc.get('generate', 0.0):.3f} s", file=err)
    for k, v in numbers.items():
        print(f"check {k} = {v!r} (limit {compare.LIMITS[k]!r})", file=err)
    return result


def emit(result: dict, out=sys.stdout) -> None:
    print(json.dumps(result), file=out, flush=True)


__all__ = ["run_cell", "emit", "banned_modules"]
