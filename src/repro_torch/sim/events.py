"""Port of `repro/sim/events.py` (copied): the deterministic
discrete-event scheduler.

All protocol-level simulation (replica crashes, view changes, message
delivery) runs on a single logical timeline measured in *reference* seconds.
Entities never read this reference time directly -- they read their local
:class:`repro_torch.core.clock.Clock`, which maps reference time to (possibly
skewed) local time, exactly as in the paper's model (S2.1).

Determinism: ties are broken by a monotonically increasing sequence number,
so two runs with the same seed produce identical traces.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass(order=True)
class Event:
    time: float
    seq: int
    callback: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)
    tag: str = field(default="", compare=False)

    def cancel(self) -> None:
        self.cancelled = True


class EventScheduler:
    """A deterministic min-heap event loop."""

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._counter = itertools.count()
        self._now = 0.0
        self.n_dispatched = 0

    @property
    def now(self) -> float:
        """Current reference time (seconds)."""
        return self._now

    def schedule_at(self, time: float, callback: Callable[[], None], tag: str = "") -> Event:
        if time < self._now:
            # Never travel back in time; clamp to "immediately next".
            time = self._now
        ev = Event(time=time, seq=next(self._counter), callback=callback, tag=tag)
        heapq.heappush(self._heap, ev)
        return ev

    def schedule_after(self, delay: float, callback: Callable[[], None], tag: str = "") -> Event:
        return self.schedule_at(self._now + max(delay, 0.0), callback, tag=tag)

    def empty(self) -> bool:
        return not any(not e.cancelled for e in self._heap)

    def step(self) -> Optional[Event]:
        """Dispatch the next non-cancelled event. Returns it, or None if drained."""
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self._now = ev.time
            self.n_dispatched += 1
            ev.callback()
            return ev
        return None

    def run(self, until: float = float("inf"), max_events: int = 50_000_000) -> None:
        """Run until the heap drains, `until` is passed, or max_events dispatched."""
        dispatched = 0
        while self._heap and dispatched < max_events:
            ev = self._heap[0]
            if ev.cancelled:
                heapq.heappop(self._heap)
                continue
            if ev.time > until:
                self._now = until
                return
            heapq.heappop(self._heap)
            self._now = ev.time
            self.n_dispatched += 1
            dispatched += 1
            ev.callback()

    def run_for(self, duration: float) -> None:
        self.run(until=self._now + duration)


__all__ = ["Event", "EventScheduler"]
