"""Host spans and counters inside the epoch loop, one tracer per process.

A span times a stretch of host code by name (``with span("sample"):``); a
counter adds whole numbers by name (``count("given_up", 3)``). Totals stay
in memory: seconds and calls of each span, the value of each counter, and
one (valid lanes, padded lanes) pair per call of an epoch body.
`snapshot()` returns them, `reset()` clears them.

The tracer records only while a torch profiler records, or inside
`recording()`. Otherwise a call site costs one check and nothing else.
The state is process-wide, as a profiler is.

Under a profiler, a span of host work alone also enters the profiler's
trace as a ``record_function`` range named ``nezha.<name>``, on the device
trace's clock, so an idle gap of the device can be matched to the host
stage that holds it. A span that encloses device work (``device=True``:
operand upload, the epoch body, the pull) stays off the trace, which holds
its kernels and copies already: a range around them would come back as a
device-side annotation, and a reader of the trace would count it as busy.

Garbage-collector pauses are the span ``gc`` (through `gc.callbacks`),
wherever the collector runs while the tracer records.

Names the port records, and what reads them (``bench/metrics/``):

  spans     sample, dispatch, deliver_log, absorb, viewchange, pop_due, gc
  counters  body_dispatches, lanes_valid, lanes_padded (`body_dispatch`);
            epochs_window, epochs_single; retry_gen_<k> (re-issues whose
            attempt count is k), given_up; viewchanges_done
"""
from __future__ import annotations

import gc
import time
from contextlib import contextmanager, nullcontext

import torch

_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter
_OFF = nullcontext()

_depth = 0                              # open `recording()` contexts
_seconds: dict[str, float] = {}
_calls: dict[str, int] = {}
_counts: dict[str, int] = {}
_dispatches: list[tuple[int, int]] = []


def on() -> bool:
    """Whether the tracer records now."""
    return bool(_depth) or _profiling()


@contextmanager
def recording():
    """Record without a profiler (operators, `chip_smoke.py`)."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def _add(name: str, seconds: float) -> None:
    _seconds[name] = _seconds.get(name, 0.0) + seconds
    _calls[name] = _calls.get(name, 0) + 1


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str, rf):
        self.name = name
        self.rf = rf

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _add(self.name, dt)
        return False


def _range(name: str):
    return torch.autograd.profiler.record_function("nezha." + name)


def span(name: str, device: bool = False):
    """Time the ``with`` block as span ``name``. ``device``: the block
    enqueues device work, and the span stays off the profiler's trace."""
    if not _depth and not _profiling():
        return _OFF
    return _Span(name, None if device or not _profiling() else _range(name))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    if _depth or _profiling():
        _counts[name] = _counts.get(name, 0) + int(n)


def body_dispatch(n_valid, n_pad: int) -> None:
    """One call of an epoch body over ``len(n_valid)`` groups of ``n_pad``
    lanes, ``n_valid`` of each group real requests: the counters
    body_dispatches, lanes_valid and lanes_padded, and the call's pair
    (the most valid lanes of a group, ``n_pad``)."""
    if not _depth and not _profiling():
        return
    valid = [int(n) for n in n_valid]
    count("body_dispatches")
    count("lanes_valid", sum(valid))
    count("lanes_padded", len(valid) * int(n_pad))
    _dispatches.append((max(valid), int(n_pad)))


def snapshot() -> dict:
    """The totals: ``seconds`` and ``calls`` of each span, ``counts``, and
    ``dispatches`` (one (valid, padded) pair a body call, in order)."""
    return {"seconds": dict(_seconds), "calls": dict(_calls),
            "counts": dict(_counts), "dispatches": list(_dispatches)}


def reset() -> None:
    _seconds.clear()
    _calls.clear()
    _counts.clear()
    _dispatches.clear()


_gc_open: list = []                     # (start, range) of a pause being timed


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if _depth or _profiling():
            rf = _range("gc") if _profiling() else None
            if rf is not None:
                rf.__enter__()
            _gc_open.append((_clock(), rf))
    elif _gc_open:
        t0, rf = _gc_open.pop()
        dt = _clock() - t0
        if rf is not None:
            rf.__exit__(None, None, None)
        _add("gc", dt)


gc.callbacks.append(_on_gc)

__all__ = ["on", "recording", "span", "count", "body_dispatch", "snapshot",
           "reset"]
