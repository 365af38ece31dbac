"""Cluster epochs: host seconds in `PendingBuffer.pop_due` (taking each
epoch's due requests out of the pending buffer, time-sorted, and keeping
the rest; every path pops once an epoch and group; span ``pop_due``) over
the traced window, per request committed in it."""
from harness.spans import per_committed, snapshot

LAYER = "cluster epochs"
SOURCE = "program_span"
UNIT = "us/req"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    snap = snapshot()
    if snap is None:
        return None
    return per_committed(rec, snap["seconds"].get("pop_due", 0.0), 1e6)
