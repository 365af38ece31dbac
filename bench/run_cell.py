"""Run one cell of the benchmark and print its result line.

    python3 bench/run_cell.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Needs an NVIDIA GPU: without one (or with
fewer cards than the cell asks for) it exits non-zero and prints no
result. See bench/README.md.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # every build and kernel cache at a fixed path inside the checkout
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from harness.run import banned_modules, emit, run_cell
    from harness.spec import Spec

    cell = Spec(ROOT).cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"run_cell: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = banned_modules()
    if bad:
        print(f"run_cell: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
