"""Cluster epochs: the share of the epochs with requests in the traced
window that ran inside a K-epoch window (counters ``epochs_window`` over
``epochs_window`` + ``epochs_single``; the per-epoch path counts where a
fault, a view change or a due retry rules the window out). 0 is a
reading: a cell whose faults keep the window path off reads it."""
from harness.spans import snapshot

LAYER = "cluster epochs"
SOURCE = "program_counter"
UNIT = "%"
BETTER = "higher"
MOVES = "commits_per_s"


def read(rec: dict):
    snap = snapshot()
    if snap is None:
        return None
    c = snap["counts"]
    window, single = c.get("epochs_window", 0), c.get("epochs_single", 0)
    if window + single == 0:
        return None
    return window / (window + single) * 100.0
