#!/usr/bin/env python3
"""Times LM paths of `chip_smoke.py` in one or more checkouts of the port in
turns, on one GPU: for each ``--arch``, `drive_lm_path` of that checkout's
`chip_smoke.py` (prefill B 2 x 4096 positions with its launch counts and
gates, kernels vs plain versions, the 4-slot server, one-slot decode vs
prefill; it raises if a check fails).

    python3 scripts/lm_paths_ab.py --tree build/ab/parent --tree . \
        [--arch seamless-m4t-large-v2 ...] [--rounds 3]

Every tree (default: this checkout) runs in a process of its own per round,
with its kernels built from its own sources into ``<tree>/build/kernels``;
rounds go first to last, then last to first (A B B A for two trees), so
drift on the card falls on both sides. Prints one JSON line a (tree,
round): the prefill's wall s and the server's, by configuration; then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path


def worker(tree: Path, archs: list) -> dict:
    """One tree's LM paths; its own package, `chip_smoke.py` and build."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    with contextlib.redirect_stdout(io.StringIO()):
        build.build_all()
    dev = torch.device("cuda", 0)
    out = {"tree": str(tree)}
    for arch in archs:
        r = chip_smoke.drive_lm_path(dev, arch)
        out[arch] = {"prefill_s": r["prefill_s"], "peak_gb": r["peak_gb"],
                     "serve_s": r["serve"]["wall_s"]}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", type=Path,
                        help="root of a checkout (repeatable)")
    parser.add_argument("--arch", action="append",
                        help="a configuration of chip_smoke.LM_PATHS "
                             "(repeatable; default seamless-m4t-large-v2 "
                             "and tinyllama-1.1b)")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    archs = args.arch or ["seamless-m4t-large-v2", "tinyllama-1.1b"]
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), archs)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("lm_paths_ab: no GPU", file=sys.stderr)
        return 1
    trees = [t.resolve() for t in (args.tree
                                   or [Path(__file__).resolve().parents[1]])]
    order = []
    for r in range(args.rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    for tree in order:
        env = dict(os.environ,
                   REPRO_TORCH_BUILD_DIR=str(tree / "build" / "kernels"))
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(tree)]
        for arch in archs:
            cmd += ["--arch", arch]
        run = subprocess.run(cmd, env=env, capture_output=True, text=True,
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
