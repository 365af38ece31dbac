"""Cluster epochs: host milliseconds of the view-change pipeline
(`VectorizedNezhaCluster._update_view` and what it calls:
`_start_view_change`, `_complete_view_change` with MERGE-LOG,
`_deliver_recovered`; span ``viewchange``, which also holds the check made
every epoch) over the traced window, per view change completed in it
(counter ``viewchanges_done``)."""
from harness.spans import snapshot

LAYER = "cluster epochs"
SOURCE = "program_span"
UNIT = "ms/viewchange"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    snap = snapshot()
    if snap is None or not snap["counts"].get("viewchanges_done"):
        return None
    return snap["seconds"].get("viewchange", 0.0) \
        / snap["counts"]["viewchanges_done"] * 1e3
