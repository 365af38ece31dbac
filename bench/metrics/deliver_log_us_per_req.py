"""Epoch body: host seconds in `DeliverStage.run` and `LogStage.run`
(delivery at the client, latency accounting, and
`ReplicaLogState.observe_epoch`; span ``deliver_log``) over the traced
window, per request committed in it."""
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
    return per_committed(rec, snap["seconds"].get("deliver_log", 0.0), 1e6)
