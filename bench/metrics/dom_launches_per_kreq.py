"""Epoch body: launches of the two DOM kernels in the window, from the
kernels' own counters (`kernels/dom_admit.py` and `kernels/dom_release.py`,
``launches_small + launches_onesweep``, read before and after), per 1000
requests committed in the window. One epoch body launches each kernel
once, for all the groups it carries."""

LAYER = "epoch body"
SOURCE = "program_counter"
UNIT = "launches/kreq"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    if rec.get("launches") is None or not rec.get("committed"):
        return None
    return rec["launches"] / rec["committed"] * 1000.0
