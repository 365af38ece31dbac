"""Device: the share of the traced window in which no operation ran on the
card (1 - busy / window, torch.profiler's CUPTI trace)."""

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "commits_per_s"


def read(rec: dict):
    if not rec.get("traced_window_s") or "busy_s" not in rec:
        return None
    return (1.0 - rec["busy_s"] / rec["traced_window_s"]) * 100.0
