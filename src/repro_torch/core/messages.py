"""Port of `repro/core/messages.py`: the operation types the workload draws.

The event backend's message dataclasses are not ported with the vectorized
data plane.
"""
from __future__ import annotations

import enum


class OpType(enum.Enum):
    READ = "read"
    WRITE = "write"
    RMW = "rmw"          # compound read-modify-write (non-commutative on keys)
    NOOP = "noop"


__all__ = ["OpType"]
