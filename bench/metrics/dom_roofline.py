"""DOM kernels: the window's admission and release at the chip's roofline,
as a share of the device time of the kernels that do them.

The least work, counted from the cell's own stream (each epoch batch of N
requests, R replicas; a batched epoch of G groups is its groups' sum), the
same whatever implements it:

  admission  reads deadlines (8N bytes) and arrivals (8NR), writes the
             admitted mask (NR); 2N events a replica ordered by
             comparison: 2NR ceil(log2 2N) operations;
  release    (the stable deadline order) reads deadlines (8N), writes a
             permutation as 4-byte indices (4N); N ceil(log2 N)
             operations.

Bound = max(bytes / peak bandwidth, operations / the float32 peak), at the
published peaks of an H100 SXM (NVIDIA's data sheet: 3.35 TB/s of HBM3,
67 TFLOP/s float32 outside the tensor cores; the 989 TFLOP/s of bf16 do
not apply, nothing here multiplies), each input byte read once and each
output byte written once; the run's result line carries the card's power
limit beside it. The kernel time is the sum of the kernels named
in `KERNELS` (by the function's name, whatever its template arguments or
namespace) over the traced window.
"""
import math
import re

LAYER = "DOM kernels"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "commits_per_s"

# csrc/dom_admit.cu, csrc/dom_release.cu and the sort they share in
# csrc/common.cuh
KERNELS = ("admit_small", "admit_count_early", "admit_place",
           "admit_tile_max", "admit_decide", "release_small",
           "onesweep_upfront", "onesweep_pass", "exclusive_sum_segments",
           "exclusive_max_segments")
_NAMED = re.compile(r"(?:^|[\s:])(%s)\s*[<(]" % "|".join(KERNELS))

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n: int, r: int) -> float:
    if n <= 0:
        return 0.0
    nbytes = 8 * n + 8 * n * r + n * r + 8 * n + 4 * n
    ops = 2 * n * r * math.ceil(math.log2(2 * n)) \
        + n * max(1, math.ceil(math.log2(max(n, 2))))
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def read(rec: dict):
    kernels = rec.get("kernels")
    if not kernels:
        return None
    t = sum(s for name, s in kernels.items() if _NAMED.search(name))
    if t <= 0.0:
        return None
    b = sum(bound_s(n, rec["replicas"]) for n in rec["epoch_sizes"])
    return b / t * 100.0
