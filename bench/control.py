"""The control of the `correct` verdict: the reference computed with its
times in float32, the nearest precision below the float64 the deployments
state, put in the system's place and judged by the same comparison.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --chunks 24

makes the calls a run of the cell makes for ``--chunks`` chunks of its
window (the warm-up span, the chunks, the drain; the same generator and
seeds as a run), replays them through the float64 reference and the
float32 one, and prints one JSON line a seed with every number compared
and whether the control came out correct (it must not). The benchmark's
own runs do not run it; it needs no GPU.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def calls(plan, chunks: int, drain_s: float) -> list:
    """The call log of a run whose window reached ``chunks`` chunks."""
    log = [("phase", "warm"), ("block", plan.block(0)),
           ("run", 2 * plan.epoch), ("run", plan.warm_s - 2 * plan.epoch),
           ("phase", "window")]
    for span in range(1, chunks + 1):
        log += [("block", plan.block(span)), ("run", plan.chunk_s)]
    return log + [("phase", "drain"), ("run", drain_s)]


def control(root: Path, workload: str, seed: int, chunks: int) -> dict:
    import numpy as np

    from harness import compare
    from harness.plan import Plan
    from harness.spec import Spec
    from reference import Deployment

    spec = Spec(root)
    cell = spec.cell(workload)
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    plan = Plan(traffic, conf, seed)
    log = calls(plan, chunks, float(traffic["drain_s"]))
    t0 = time.perf_counter()
    want = Deployment(conf, plan.clients, seed)
    want.replay(log)
    t1 = time.perf_counter()
    low = Deployment(conf, plan.clients, seed, dtype=np.float32)
    low.replay(log)
    numbers = compare.compare(low.observation(), want.observation())
    return {"workload": workload, "seed": seed, "chunks": chunks,
            "requests": len(want.uids),
            "view_changes": want.summary()["view_changes"],
            "cross_group_ops": len(want.multi),
            "reference_s": t1 - t0,
            "correct": compare.verdict(numbers), "checks": numbers}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--chunks", type=int, required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(BENCH)]
    for s in args.seeds.split(","):
        print(json.dumps(control(ROOT, args.workload, int(s), args.chunks)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
