"""Epoch body: the share of the epoch body's lanes that carry a request,
over every call in the traced window (counters ``lanes_valid`` over
``lanes_padded``; a batch pads to a power of two, a window shares its
largest epoch's bucket, and a batched call pads each of its G groups,
idle ones whole)."""
from harness.spans import snapshot

LAYER = "epoch body"
SOURCE = "program_counter"
UNIT = "%"
BETTER = "higher"
MOVES = "commits_per_s"


def read(rec: dict):
    snap = snapshot()
    if snap is None or not snap["counts"].get("lanes_padded"):
        return None
    c = snap["counts"]
    return c.get("lanes_valid", 0) / c["lanes_padded"] * 100.0
