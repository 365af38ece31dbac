"""KV-cache slot management for continuous batching.

Port of `repro/serving/kv_cache.py`. A fixed pool of `n_slots` sequences;
each slot owns a stripe of the padded cache tensors built by
`repro_torch.models.model.zero_cache`. Slot assignment is deterministic
given the admission order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Slot:
    seq_id: Optional[int] = None
    length: int = 0


class SlotPool:
    def __init__(self, n_slots: int):
        self.slots = [Slot() for _ in range(n_slots)]
        self._free = list(range(n_slots))[::-1]

    def alloc(self, seq_id: int) -> Optional[int]:
        if not self._free:
            return None
        i = self._free.pop()
        self.slots[i] = Slot(seq_id=seq_id, length=0)
        return i

    def release(self, i: int) -> None:
        self.slots[i] = Slot()
        self._free.append(i)

    def active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.seq_id is not None]

    @property
    def n_free(self) -> int:
        return len(self._free)


def write_prefill_into_cache(cache, slot: int, seq_cache):
    """Copy a single-sequence cache ([L, 1, ...] leaves) into batch slot
    ``slot`` of ``cache`` ([L, B, ...] leaves), in place; returns ``cache``."""
    if isinstance(cache, dict):
        for key in cache:
            write_prefill_into_cache(cache[key], slot, seq_cache[key])
    elif isinstance(cache, (tuple, list)):
        for dst, src in zip(cache, seq_cache):
            write_prefill_into_cache(dst, slot, src)
    else:
        cache[:, slot:slot + 1] = seq_cache        # copy_ casts the dtype
    return cache


__all__ = ["Slot", "SlotPool", "write_prefill_into_cache"]
