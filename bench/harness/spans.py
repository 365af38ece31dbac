"""The program's own spans and counters, as the per-layer metrics read
them: the totals of `repro_torch.core.spans`. The tracer records only
while a torch profiler records, so in a ``--trace 1`` run on the card its
totals cover exactly the traced window (from after the warm-up to before
the drain). Its spans of host work also enter that trace as
``nezha.<name>`` ranges."""
from __future__ import annotations


def snapshot():
    """The tracer's totals (``seconds``, ``calls``, ``counts``,
    ``dispatches``), or None where there is nothing to read: a program
    without the tracer, or a run in which it recorded nothing (no profiler
    ran, as on the CPU)."""
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    if not snap["seconds"] and not snap["counts"]:
        return None
    return snap


def per_committed(rec: dict, value: float, scale: float):
    """``value`` per request committed in the window, times ``scale``, or
    None when nothing was committed."""
    if not rec.get("committed"):
        return None
    return value / rec["committed"] * scale


__all__ = ["snapshot", "per_committed"]
