"""Epoch body: host seconds in `SampleStage.run` (the bulk network
sampling of every epoch: per-epoch, window and batched paths; span
``sample``) over the traced window, per request committed in it."""
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
    return per_committed(rec, snap["seconds"].get("sample", 0.0), 1e6)
