#!/usr/bin/env python3
"""Times the DOM kernels of one or more checkouts of the port in turns, on
one GPU: each of `dom_admit` and `dom_release` at one group (the data
plane's epochs: 16384, 4096 and 1024 lanes) and, where the checkout has it,
batched over G groups (phase 11's small-route shapes of `chip_smoke.py`).

    python3 scripts/dom_groups.py [--tree PATH ...] [--rounds 2]

Every tree (default: this checkout) runs in a process of its own per round,
with its kernels built from its own sources into ``<tree>/build/kernels``;
rounds go first to last, then last to first (A B B A for two trees), so
drift on the card falls on both sides. Times are CUDA-event means of 50
calls after a warm one, eager and replayed from a CUDA graph; the inputs
are realistic DOM batches (lognormal 60 us one-way delays, 2 % drops,
deadlines at send + 120 us) padded with +inf lanes. Prints one JSON line a
(tree, round) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ONE_GROUP = ((16_384, 10_000), (4_096, 3_907), (1_024, 977))
BATCHED = ((4, 16_384, 15_625), (16, 4_096, 3_907), (64, 1_024, 977))
REPS = 50


def batch(G: int, n_pad: int, n_valid: int, seed: int):
    import numpy as np

    d = np.full((G, n_pad), np.inf)
    a = np.full((G, n_pad, 3), np.inf)
    for g in range(G):
        rng = np.random.default_rng(seed + g)
        send = np.sort(rng.uniform(0, n_valid / 2e5, n_valid))
        d[g, :n_valid] = send + 120e-6
        a[g, :n_valid] = send[:, None] + rng.lognormal(np.log(60e-6), 0.6,
                                                       (n_valid, 3))
        a[g, :n_valid][rng.random((n_valid, 3)) < 0.02] = np.inf
    return d, a


def timed(fn) -> dict:
    import torch

    def events(run) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    fn()
    torch.cuda.synchronize()
    eager = events(lambda: [fn() for _ in range(REPS)])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return {"ms": eager, "graph_ms": events(graph.replay)}


def worker(tree: Path) -> dict:
    """Times one tree's kernels; its own package and build directory."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import build, dom_admit, dom_release

    build.build_all()
    dev = torch.device("cuda")
    out = {"tree": str(tree), "one_group": [], "batched": []}
    for n_pad, n_valid in ONE_GROUP:
        d_np, a_np = batch(1, n_pad, n_valid, seed=n_pad)
        d = torch.as_tensor(d_np[0], device=dev)
        a = torch.as_tensor(a_np[0], device=dev)
        ones = torch.ones(n_pad, dtype=torch.bool, device=dev)
        if not torch.equal(dom_admit.dom_admit(d, a),
                           dom_admit.dom_admit_plain(d, a)):
            raise RuntimeError(f"dom_admit differs at n {n_pad}")
        out["one_group"].append({
            "n": n_pad, "requests": n_valid,
            "dom_admit": timed(lambda: dom_admit.dom_admit(d, a)),
            "dom_release": timed(lambda: dom_release.dom_release(
                d, ones, float("inf")))})
    for G, n_pad, n_valid in BATCHED:
        d_np, a_np = batch(G, n_pad, n_valid, seed=G)
        d = torch.as_tensor(d_np, device=dev)
        a = torch.as_tensor(a_np, device=dev)
        ones = torch.ones((G, n_pad), dtype=torch.bool, device=dev)
        try:
            got = dom_admit.dom_admit(d, a)
        except ValueError:          # a tree without the batched form
            break
        if not torch.equal(got, dom_admit.dom_admit_plain(d, a)):
            raise RuntimeError(f"batched dom_admit differs at G {G}")
        out["batched"].append({
            "G": G, "n": n_pad, "requests": n_valid,
            "dom_admit": timed(lambda: dom_admit.dom_admit(d, a)),
            "dom_release": timed(lambda: dom_release.dom_release(
                d, ones, float("inf")))})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", type=Path,
                        help="root of a checkout (repeatable)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("dom_groups: no GPU", file=sys.stderr)
        return 1
    trees = [t.resolve() for t in (args.tree
                                   or [Path(__file__).resolve().parents[1]])]
    order = []
    for r in range(args.rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    for tree in order:
        env = dict(os.environ,
                   REPRO_TORCH_BUILD_DIR=str(tree / "build" / "kernels"))
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(tree)], env=env, capture_output=True, text=True,
            timeout=900)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
