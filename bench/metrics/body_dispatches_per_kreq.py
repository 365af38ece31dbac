"""Epoch body: calls of the epoch body in the traced window (counter
``body_dispatches``: one an epoch with requests, whether single, inside a
K-epoch window, or batched over G groups), per 1000 requests committed in
it. Each call launches each DOM kernel once, so this reads half of
``dom_launches_per_kreq``."""
from harness.spans import per_committed, snapshot

LAYER = "epoch body"
SOURCE = "program_counter"
UNIT = "dispatches/kreq"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    snap = snapshot()
    if snap is None:
        return None
    return per_committed(rec, snap["counts"].get("body_dispatches", 0), 1e3)
