"""Port of `repro/core/dom.py` (copied).

Deadline-Ordered Multicast (DOM) -- the paper's core primitive (S4).

Sender side (DOM-S): stamps each message with sending time `s` (local,
synchronized clock) and latency bound `l`; deadline = s + l. The latency
bound is the max over receivers of

    OWD~ = clamp(P + beta * (sigma_S + sigma_R), 0, D)

where P is a percentile of a sliding window of OWD samples for that
(sender, receiver) path, sigma_* are the clock-sync error estimates, and D
is the clamp ceiling (S4's "predefined scope [0, D]").

Receiver side (DOM-R): the *early-buffer* is a priority queue by deadline;
a message enters iff its deadline exceeds the deadline of the last released
message that is *non-commutative* with it (S8.2 relaxation); messages are
released once local clock time passes their deadline, in deadline order
(ties broken by <client-id, request-id>). Ineligible messages go to the
*late-buffer* (a map keyed by <client-id, request-id>).

DOM is best-effort: it guarantees consistent ordering of released messages,
never set-equality (S3) -- that is Nezha's job.

This module gives the exact event-driven implementation; the vectorized
engine (`repro_torch.core.engine`) evaluates the same bound over a ring
pool on the device, and releases through the `dom_admit` / `dom_release`
kernels (`repro_torch.kernels`).
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Hashable, Optional

import numpy as np

from repro_torch.core.messages import Request


@dataclass
class DomParams:
    percentile: float = 50.0        # P's percentile (paper default: 50th)
    window: int = 1000              # sliding-window size for OWD samples
    beta: float = 3.0               # clock-error margin multiplier
    clamp_d: float = 200e-6         # D: clamp ceiling for OWD~ (s)
    initial_owd: float = 100e-6     # bootstrap before samples exist
    zero_bound: bool = False        # ablation (Fig 9 "No-DOM"): l = 0, so
    #   ordering degenerates to leader arrival order via the slow path


class OwdEstimator:
    """Receiver-side sliding-window percentile OWD estimator for one path.

    The receiver records sample = receive_local_time - msg.send_time and
    replies the clamped estimate to the sender (piggybacked on replies),
    which uses the max across receivers as the next latency bound.
    """

    def __init__(self, params: DomParams):
        self.p = params
        self._win: deque[float] = deque(maxlen=params.window)

    def record(self, send_time: float, recv_local_time: float) -> None:
        self._win.append(recv_local_time - send_time)

    def estimate(self, sigma_s: float, sigma_r: float) -> float:
        # sigma_s/sigma_r are the sender/receiver clock error bounds. Under
        # a modeled sync loop (ClockParams.sync_model) they are the
        # sync daemon's *measured* bounds -- MAD-derived, grown since the
        # last probe round -- so DOM's margin tracks actual sync quality
        # instead of a configured constant.
        p = self.p
        if not self._win:
            base = p.initial_owd
        else:
            base = float(np.percentile(np.asarray(self._win), p.percentile))
        est = base + p.beta * (sigma_s + sigma_r)
        # Clamp (S4): invalid (negative / huge) estimates fall back to D.
        if not (0.0 < est < p.clamp_d):
            est = p.clamp_d
        return est


class DomSender:
    """DOM-S: tracks per-receiver OWD estimates; computes latency bounds."""

    def __init__(self, n_receivers: int, params: Optional[DomParams] = None):
        self.p = params or DomParams()
        self._est = np.full(n_receivers, self.p.initial_owd)

    def on_estimate(self, receiver: int, owd_estimate: float) -> None:
        self._est[receiver] = owd_estimate

    def latency_bound(self) -> float:
        """max over receivers of the latest OWD~ (S5: deadline covers all)."""
        if self.p.zero_bound:
            return 0.0
        return float(self._est.max())

    def stamp(self, send_local_time: float) -> tuple[float, float]:
        l = self.latency_bound()
        return send_local_time, l


@dataclass(order=True)
class _EbEntry:
    deadline: float
    tiebreak: tuple = field(compare=True)
    request: Request = field(compare=False)


class EarlyBuffer:
    """Priority queue by deadline with the commutativity-aware entrance check.

    `last_released(key)` tracks, per commutativity class, the largest deadline
    released so far; with commutativity disabled there is one global class.
    """

    def __init__(self, commutative: bool = True):
        self.commutative = commutative
        self._heap: list[_EbEntry] = []
        self._last_released: dict[Hashable, float] = {}
        self._global_last: float = -np.inf
        self._counter = itertools.count()

    def _classes(self, req: Request) -> tuple[Hashable, ...]:
        if not self.commutative:
            return ("__all__",)
        # Reads commute with everything except writes to the same keys; a
        # request's classes are the keys it *touches* (writes constrain both).
        return tuple(req.keys) if req.keys else ("__all__",)

    def last_released_deadline(self, req: Request) -> float:
        """Largest released deadline among entries non-commutative with req."""
        if not self.commutative:
            return self._global_last
        rel = -np.inf
        for k in self._classes(req):
            v = self._last_released.get(k, -np.inf)
            if req.is_write:
                rel = max(rel, v)
            else:
                # A read conflicts only with *writes* on the same key; our
                # per-class trackers only record writes (see release()).
                rel = max(rel, v)
        return rel

    def eligible(self, req: Request) -> bool:
        return req.deadline > self.last_released_deadline(req)

    def insert(self, req: Request) -> bool:
        """Insert if eligible. Returns False if the request must go late."""
        if not self.eligible(req):
            return False
        heapq.heappush(
            self._heap,
            _EbEntry(deadline=req.deadline, tiebreak=(req.client_id, req.request_id), request=req),
        )
        return True

    def peek_deadline(self) -> Optional[float]:
        return self._heap[0].deadline if self._heap else None

    def release_ready(self, local_time: float) -> list[Request]:
        """Release all requests whose deadline <= local clock time, in order."""
        out: list[Request] = []
        while self._heap and self._heap[0].deadline <= local_time:
            e = heapq.heappop(self._heap)
            self._note_release(e.request)
            out.append(e.request)
        return out

    def _note_release(self, req: Request) -> None:
        self._global_last = max(self._global_last, req.deadline)
        if self.commutative and req.is_write:
            for k in self._classes(req):
                self._last_released[k] = max(self._last_released.get(k, -np.inf), req.deadline)
        elif self.commutative and not req.keys:
            self._last_released["__all__"] = max(
                self._last_released.get("__all__", -np.inf), req.deadline
            )

    def drain_all(self) -> list[Request]:
        """Remove and return every queued request (recovery re-validation)."""
        out = [e.request for e in sorted(self._heap)]
        self._heap = []
        return out

    def force_last_released(self, req_or_deadline, deadline: float | None = None) -> None:
        """Recovery step 9 (SA.2): seed the entrance check from a recovered log."""
        if deadline is None:
            req: Request = req_or_deadline
            self._note_release(req)
        else:
            self._global_last = max(self._global_last, deadline)

    def __len__(self) -> int:
        return len(self._heap)


class LateBuffer:
    """Map <client-id, request-id> -> request (S6.1)."""

    def __init__(self):
        self._m: dict[tuple[int, int], Request] = {}

    def insert(self, req: Request) -> None:
        self._m[(req.client_id, req.request_id)] = req

    def pop(self, client_id: int, request_id: int) -> Optional[Request]:
        return self._m.pop((client_id, request_id), None)

    def get(self, client_id: int, request_id: int) -> Optional[Request]:
        return self._m.get((client_id, request_id))

    def __len__(self) -> int:
        return len(self._m)


class DomReceiver:
    """DOM-R: early/late buffers + release pump driven by the local clock.

    `on_release` is the hook into the consensus layer (append to log).
    The receiver also owns the per-sender OWD estimators.
    """

    def __init__(
        self,
        params: Optional[DomParams] = None,
        commutative: bool = True,
        on_release: Optional[Callable[[Request], None]] = None,
    ):
        self.p = params or DomParams()
        self.early = EarlyBuffer(commutative=commutative)
        self.late = LateBuffer()
        self.on_release = on_release or (lambda r: None)
        self._estimators: dict[int, OwdEstimator] = {}

    def estimator(self, sender: int) -> OwdEstimator:
        if sender not in self._estimators:
            self._estimators[sender] = OwdEstimator(self.p)
        return self._estimators[sender]

    def receive(self, req: Request, recv_local_time: float, sigma_s: float, sigma_r: float) -> tuple[bool, float]:
        """Process an arriving message. Returns (entered_early, owd_estimate)."""
        est = self.estimator(req.proxy_id)
        est.record(req.send_time, recv_local_time)
        owd = est.estimate(sigma_s, sigma_r)
        entered = self.early.insert(req)
        if not entered:
            self.late.insert(req)
        return entered, owd

    def pump(self, local_time: float) -> list[Request]:
        """Release everything due; deliver to the consensus layer in order."""
        released = self.early.release_ready(local_time)
        for r in released:
            self.on_release(r)
        return released


__all__ = [
    "DomParams",
    "OwdEstimator",
    "DomSender",
    "EarlyBuffer",
    "LateBuffer",
    "DomReceiver",
]
