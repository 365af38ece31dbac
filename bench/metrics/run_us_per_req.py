"""Cluster epochs: host wall time inside the benchmark's ``run_for``
calls, each ending in a device synchronize (`vectorized_cluster.run_for`
and its K-epoch windows, `sharded.run_for` and its batched epochs), over
the window, per request committed in the window."""

LAYER = "cluster epochs"
SOURCE = "host_clock"
UNIT = "us/req"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    if not rec.get("committed"):
        return None
    return rec["run_s"] / rec["committed"] * 1e6
