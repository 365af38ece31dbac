"""Port of `repro/core/messages.py` (copied): Nezha message formats
(paper S6.2) plus recovery messages (SA).

Every message is a plain dataclass; the simulator moves them by value.
Deadlines/times are floats in seconds of *local synchronized time*; the
hash fields are 64-bit ints from repro_torch.core.hashing.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence


class Status(enum.Enum):
    NORMAL = "normal"
    VIEWCHANGE = "viewchange"
    RECOVERING = "recovering"


class OpType(enum.Enum):
    READ = "read"
    WRITE = "write"
    RMW = "rmw"          # compound read-modify-write (non-commutative on keys)
    NOOP = "noop"


@dataclass
class Request:
    """request = <client-id, request-id, command, s, l> (S6.2).

    `keys`/`op` drive the commutativity optimization (S8.2); `command` is an
    opaque payload executed by the leader's state machine. `proxy_id` is the
    DOM sender (needed for OWD bookkeeping); deadline = s + l, but the leader
    may *overwrite* deadline on the slow path (Fig 5 step 3), so it is stored
    explicitly.
    """

    client_id: int
    request_id: int
    command: object = None
    send_time: float = 0.0            # s  (proxy's synchronized clock)
    latency_bound: float = 0.0        # l
    deadline: float = 0.0             # s + l, possibly overwritten by leader
    proxy_id: int = 0
    op: OpType = OpType.WRITE
    keys: tuple = ()

    def __post_init__(self):
        if self.deadline == 0.0:
            self.deadline = self.send_time + self.latency_bound

    @property
    def is_write(self) -> bool:
        return self.op in (OpType.WRITE, OpType.RMW)

    @property
    def uid(self) -> tuple[int, int]:
        return (self.client_id, self.request_id)

    def with_deadline(self, deadline: float) -> "Request":
        return replace(self, deadline=deadline)


@dataclass
class LogEntry:
    """A released request in a replica log, ordered by (deadline, uid)."""

    deadline: float
    client_id: int
    request_id: int
    request: Request
    result: object = None   # only populated on the leader (speculative exec)

    @property
    def key3(self) -> tuple[float, int, int]:
        """The identifying 3-tuple <deadline, client-id, request-id>."""
        return (self.deadline, self.client_id, self.request_id)

    @property
    def uid(self) -> tuple[int, int]:
        return (self.client_id, self.request_id)


@dataclass
class FastReply:
    """fast-reply = <view-id, replica-id, client-id, request-id, result, hash>."""

    view_id: int
    replica_id: int
    client_id: int
    request_id: int
    result: object
    hash: int
    deadline: float = 0.0     # carried for proxy-side diagnostics only
    is_slow: bool = False     # True -> this is a slow-reply (subsumes fast)


@dataclass
class SlowReply:
    """slow-reply = <view-id, replica-id, client-id, request-id>."""

    view_id: int
    replica_id: int
    client_id: int
    request_id: int


@dataclass
class LogModification:
    """log-modification = <view-id, log-id, client-id, request-id, deadline>.

    Broadcast leader->followers for every appended entry; doubles as the
    heartbeat. Batched under load (S6.2). In the No-DOM ablation the leader
    must also ship the request payload (followers never saw it), which is
    what recreates the Multi-Paxos leader bottleneck (Fig 9).
    """

    view_id: int
    log_id: int               # position in the leader's log
    client_id: int
    request_id: int
    deadline: float
    request: Optional[Request] = None   # No-DOM ablation only


@dataclass
class LogStatus:
    """log-status = <view-id, replica-id, sync-point> (follower -> leader)."""

    view_id: int
    replica_id: int
    sync_point: int


@dataclass
class CommitNotice:
    """leader -> followers: commit-point broadcast (S8.3 periodic checkpoints)."""

    view_id: int
    commit_point: int


# -- recovery / view change (SA, Algorithms 3 & 4) ---------------------------
@dataclass
class CrashVectorReq:
    replica_id: int
    nonce: str


@dataclass
class CrashVectorRep:
    replica_id: int
    nonce: str
    crash_vector: tuple


@dataclass
class RecoveryReq:
    replica_id: int
    crash_vector: tuple


@dataclass
class RecoveryRep:
    replica_id: int
    view_id: int
    crash_vector: tuple


@dataclass
class StateTransferReq:
    replica_id: int
    crash_vector: tuple


@dataclass
class StateTransferRep:
    replica_id: int
    view_id: int
    crash_vector: tuple
    log: list
    sync_point: int


@dataclass
class ViewChangeReq:
    replica_id: int
    view_id: int
    crash_vector: tuple


@dataclass
class ViewChange:
    replica_id: int
    view_id: int
    crash_vector: tuple
    log: list
    sync_point: int
    last_normal_view: int


@dataclass
class StartView:
    replica_id: int
    view_id: int
    crash_vector: tuple
    log: list


__all__ = [
    "Status",
    "OpType",
    "Request",
    "LogEntry",
    "FastReply",
    "SlowReply",
    "LogModification",
    "LogStatus",
    "CommitNotice",
    "CrashVectorReq",
    "CrashVectorRep",
    "RecoveryReq",
    "RecoveryRep",
    "StateTransferReq",
    "StateTransferRep",
    "ViewChangeReq",
    "ViewChange",
    "StartView",
]
