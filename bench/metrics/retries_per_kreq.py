"""Cluster epochs: client re-issues in the traced window (the counters
``retry_gen_<k>``, k the attempts a request made before it, summed;
abandonments are not re-issues), per 1000 requests committed in it."""
from harness.spans import per_committed, snapshot

LAYER = "cluster epochs"
SOURCE = "program_counter"
UNIT = "retries/kreq"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    snap = snapshot()
    if snap is None:
        return None
    retries = sum(n for name, n in snap["counts"].items()
                  if name.startswith("retry_gen_"))
    return per_committed(rec, retries, 1e3)
