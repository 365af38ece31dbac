"""Cluster epochs: host seconds in
`VectorizedNezhaCluster._absorb_epoch_state` (the cluster's per-epoch
bookkeeping: stamp audit, latencies, the commit trace, client retries;
span ``absorb``, which also holds the retries of an outage) over the
traced window, per request committed in it."""
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
    return per_committed(rec, snap["seconds"].get("absorb", 0.0), 1e6)
