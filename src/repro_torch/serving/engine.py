"""Continuous-batching serving engine for one model replica.

Port of `repro/serving/engine.py` (`ServingEngine`, `GenRequest`): admit
requests into KV slots, one decode step per tick over the whole batch,
greedy sampling. Admission steps each prompt token by token through the
decode step, exactly as the reference does; each step runs every slot's
row at the stepped slot's position, so it also writes the other slots'
cache there (the reference's behaviour, kept). The replicated service
(`ReplicatedLMService`, `_LMStateMachine`) rides on the event-driven
`nezha` backend, which the port does not have yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.model import make_decode_step, zero_cache
from repro_torch.serving.kv_cache import SlotPool


@dataclass
class GenRequest:
    seq_id: int
    prompt: list
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Continuous-batching engine for one model replica (greedy decode).
    It runs on the device its parameters lie on."""

    def __init__(self, cfg: ArchConfig, params: dict, *, n_slots: int = 4,
                 max_seq: int = 256):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.device = params["embed"].device
        self.pool = SlotPool(n_slots)
        self.cache = zero_cache(cfg, n_slots, max_seq, device=self.device)
        self.decode = make_decode_step(cfg)
        self.requests: dict[int, GenRequest] = {}
        self.slot_of: dict[int, int] = {}
        self.lengths = np.zeros(n_slots, dtype=np.int32)
        self.last_token = np.zeros(n_slots, dtype=np.int32)

    # -- admission --------------------------------------------------------------
    def admit(self, req: GenRequest) -> bool:
        slot = self.pool.alloc(req.seq_id)
        if slot is None:
            return False
        self.requests[req.seq_id] = req
        self.slot_of[req.seq_id] = slot
        # "prefill" by stepping the prompt token by token into this slot
        for t in req.prompt:
            self._step_slot(slot, t)
        self.last_token[slot] = req.prompt[-1] if req.prompt else 0
        return True

    def _step_slot(self, slot: int, token: int) -> int:
        tokens = np.zeros((len(self.pool.slots), 1), dtype=np.int32)
        tokens[slot] = token
        logits, self.cache = self.decode(
            self.params, self.cache,
            torch.as_tensor(tokens, device=self.device),
            int(self.lengths[slot]))
        self.lengths[slot] += 1
        return int(torch.argmax(logits[slot]).cpu())

    # -- decode tick ---------------------------------------------------------------
    def tick(self) -> int:
        """One decode step for every active slot. Returns #tokens produced."""
        active = [i for i in self.pool.active()
                  if not self.requests[self.pool.slots[i].seq_id].done]
        n = 0
        for slot in active:
            seq_id = self.pool.slots[slot].seq_id
            req = self.requests[seq_id]
            nxt = self._step_slot(slot, int(self.last_token[slot]))
            req.out.append(nxt)
            self.last_token[slot] = nxt
            n += 1
            if (len(req.out) >= req.max_new
                    or self.lengths[slot] >= self.max_seq - 1):
                req.done = True
                self.pool.release(slot)
        return n

    def state_fingerprint(self) -> int:
        """Hash of (lengths, last tokens, outputs) -- replicas must agree."""
        parts = tuple(self.lengths.tolist()) + tuple(self.last_token.tolist())
        outs = tuple(tuple(r.out) for _, r in sorted(self.requests.items()))
        return hash((parts, outs))


__all__ = ["ServingEngine", "GenRequest"]
