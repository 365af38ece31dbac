"""Submission: host wall time inside the benchmark's own ``submit_at``
calls (one a request: `vectorized_cluster.submit_at`, the sharded layer's
routing in `sharded.submit_at`, `engine.PendingBuffer.append`) over the
window, per request submitted."""

LAYER = "submission"
SOURCE = "host_clock"
UNIT = "us/req"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    if not rec.get("submitted"):
        return None
    return rec["submit_s"] / rec["submitted"] * 1e6
