"""Serving engines.

Port of `repro/serving/engine.py`.

ServingEngine: single-replica continuous batching -- admit requests into KV
slots, one decode step per tick over the whole batch, greedy sampling. Admission steps each prompt token by token through the
decode step, exactly as the reference does; each step runs every slot's
row at the stepped slot's position, so it also writes the other slots'
cache there (the reference's behaviour, kept). The cache is the
reference's `zero_cache` with no source length, so an encoder-decoder
(seamless) serves against an all-zero cross-attention cache of
``n_frontend_tokens`` frames, and a vision model (phi-3-vision) serves
text only: the decode step has no frontend (both the reference's
behaviour, kept). ``n_steps`` counts the decode steps an engine ran.

ReplicatedLMService: the paper's architecture applied to inference. 2f+1
model replicas form a replicated state machine whose commands are "admit
request R", "tick" and "result of R", ordered by the event-driven `nezha`
backend (`repro_torch.core.protocol`, on the host). DOM gives every replica
the same admission order, so slot assignment, batch composition and greedy
decode results agree across replicas, and a client can fail over to any
replica. The engines run on the device the parameters lie on (the card
unless the caller passes CPU parameters); the replicas share the one copy
of the parameters, and each keeps its own cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.messages import OpType
from repro_torch.core.protocol import ClusterConfig
from repro_torch.core.registry import make_cluster
from repro_torch.core.replica import StateMachine
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
        self.n_steps = 0

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
        self.n_steps += 1
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


class _LMStateMachine(StateMachine):
    """Nezha state machine whose commands drive a ServingEngine."""

    def __init__(self, make_engine: Callable[[], ServingEngine]):
        self.engine = make_engine()

    def execute(self, command):
        kind = command[0]
        if kind == "ADMIT":
            _, seq_id, prompt, max_new = command
            ok = self.engine.admit(GenRequest(seq_id=seq_id,
                                              prompt=list(prompt),
                                              max_new=max_new))
            return ("ADMITTED", seq_id) if ok else ("REJECTED", seq_id)
        if kind == "TICK":
            n = self.engine.tick()
            return ("TICKED", n, self.engine.state_fingerprint())
        if kind == "RESULT":
            _, seq_id = command
            req = self.engine.requests.get(seq_id)
            return tuple(req.out) if req else None
        return None

    def snapshot(self):  # engines re-execute the log on recovery
        return None

    def restore(self, snap):
        pass


class ReplicatedLMService:
    """2f+1 LM replicas behind Nezha; commands are DOM-ordered."""

    def __init__(self, cfg: ArchConfig, params: dict, *, f: int = 1,
                 n_slots: int = 4, max_seq: int = 128, seed: int = 0):
        # Every engine the replicas made, in order: a relaunched replica
        # and a new leader rebuild theirs and re-execute the log.
        self.engines_made: list[ServingEngine] = []

        def make_engine() -> ServingEngine:
            eng = ServingEngine(cfg, params, n_slots=n_slots, max_seq=max_seq)
            self.engines_made.append(eng)
            return eng

        ccfg = ClusterConfig(f=f, n_proxies=1, n_clients=1, seed=seed)
        self.cluster = make_cluster(
            "nezha", ccfg, sm_factory=lambda: _LMStateMachine(make_engine))
        self.cluster.start()
        self._completed: dict[int, object] = {}
        self.cluster.on_commit = lambda cid, rid: self._completed.setdefault(
            rid, self.cluster.result_of(cid, rid))
        self._next_seq = 0

    def _run(self, command, keys=("svc",)) -> object:
        _, rid = self.cluster.submit(0, command=command, op=OpType.RMW,
                                     keys=keys)
        for _ in range(400):
            self.cluster.run_for(5e-3)
            if rid in self._completed:
                return self._completed.pop(rid)
        raise TimeoutError("service did not commit")

    def submit_prompt(self, prompt: list, max_new: int = 8) -> int:
        seq_id = self._next_seq
        self._next_seq += 1
        res = self._run(("ADMIT", seq_id, tuple(prompt), max_new))
        assert res[0] == "ADMITTED", res
        return seq_id

    def step(self) -> tuple:
        return self._run(("TICK",))

    def result(self, seq_id: int):
        return self._run(("RESULT", seq_id))

    def leader_engine(self) -> ServingEngine:
        return self.cluster.replicas[self.cluster.leader_id].sm.engine


__all__ = ["ServingEngine", "ReplicatedLMService", "GenRequest"]
