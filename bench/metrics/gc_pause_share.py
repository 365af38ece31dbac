"""Host runtime: the share of the traced window's seconds that the
Python garbage collector held the process (span ``gc``, timed through
`gc.callbacks`). The window leaves out the benchmark's own generator, but
the pauses inside it are in this count: the program cannot tell them
apart."""
from harness.spans import snapshot

LAYER = "host runtime"
SOURCE = "program_span"
UNIT = "%"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    snap = snapshot()
    if snap is None or not rec.get("traced_window_s"):
        return None
    return snap["seconds"].get("gc", 0.0) / rec["traced_window_s"] * 100.0
