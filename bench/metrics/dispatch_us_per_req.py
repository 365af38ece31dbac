"""Epoch body: host seconds from the operands' packing to the outputs back
on the host (span ``dispatch``: `FusedEpochStage.run`, the device half of
`DomEngine.run_window`, the sharded batched epoch's packing and
`DomEngine.step`; upload, the body's launches and the one pull, which
waits for the device) over the traced window, per request committed in
it. Timed on the host clock alone: the span is kept off the profiler's
trace, which holds its kernels and copies."""
from harness.spans import per_committed, snapshot

LAYER = "epoch body"
SOURCE = "program_span"
UNIT = "us/req"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    snap = snapshot()
    if snap is None:
        return None
    return per_committed(rec, snap["seconds"].get("dispatch", 0.0), 1e6)
