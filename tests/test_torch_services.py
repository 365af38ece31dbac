"""The replicated services on the port's event-driven `nezha` backend
against the reference's, on the CPU: `ReplicatedLMService` (tinyllama-1.1b
at `smoke_config`, the reference's parameters carried across with
`params_from_reference`, both packages computing in float32),
`ReplicatedMetadataLog`, and `python -m repro_torch.launch.serve`.

Tolerance: the consensus side is bit for bit (every summary key). The
generated tokens are equal; where one differs, the reference's top-2
logits at that step must lie within 1e-4 of each other (a near-tie the
two frameworks' summation orders may break either way), and the rest of
that sequence is not compared. The port's service must equal its own lone
`ServingEngine` fed the same ADMIT/TICK sequence, token for token.
"""
import math
import sys

import jax
import numpy as np
import pytest
import torch

import repro.models.layers as jl
import repro.models.model as jm
import repro_torch.models.layers as tl
import repro_torch.models.model as tm
from repro.ckpt.replicated_log import ReplicatedMetadataLog as RLog
from repro.configs import smoke_config as j_smoke_config
from repro.serving.engine import GenRequest as JGenRequest
from repro.serving.engine import ReplicatedLMService as JService
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.ckpt.replicated_log import ReplicatedMetadataLog as PLog
from repro_torch.configs import smoke_config
from repro_torch.serving.engine import (
    GenRequest,
    ReplicatedLMService,
    ServingEngine,
)

ARCH = "tinyllama-1.1b"
NEAR_TIE = 1e-4
N_PROMPTS, PROMPT_LEN, MAX_NEW = 4, 8, 8


@pytest.fixture(scope="module")
def params():
    cfg_j, cfg_t = j_smoke_config(ARCH), smoke_config(ARCH)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = tm.params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture
def f32_compute(monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setattr(jl, "CDT", jnp.float32)
    monkeypatch.setattr(jm, "CDT", jnp.float32)
    monkeypatch.setattr(tl, "CDT", torch.float32)
    monkeypatch.setattr(tm, "CDT", torch.float32)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, PROMPT_LEN).tolist()
            for _ in range(N_PROMPTS)]


def _serve(svc, prompts):
    ids = [svc.submit_prompt(p, max_new=MAX_NEW) for p in prompts]
    ticks = [svc.step() for _ in range(MAX_NEW)]
    return ids, ticks, [tuple(svc.result(s)) for s in ids]


class _GapProbe(JServingEngine):
    """A lone reference engine that records, for every generated token,
    the gap between its top-2 logits: ``gaps[(seq_id, index)]``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gaps, decode = {}, self.decode

        def probe(*args):
            out = decode(*args)
            self._last = np.asarray(out[0], np.float64)
            return out
        self.decode = probe

    def _step_slot(self, slot, token):
        nxt = super()._step_slot(slot, token)
        seq_id = self.pool.slots[slot].seq_id
        top2 = np.sort(self._last[slot])[-2:]
        self.gaps[(seq_id, len(self.requests[seq_id].out))] = top2[1] - top2[0]
        return nxt


def _lone(engine, prompts):
    for i, p in enumerate(prompts):
        req = GenRequest if isinstance(engine, ServingEngine) else JGenRequest
        assert engine.admit(req(seq_id=i, prompt=p, max_new=MAX_NEW))
    for _ in range(MAX_NEW):
        engine.tick()
    return [tuple(engine.requests[i].out) for i in range(len(prompts))]


def test_replicated_lm_service_equals_the_reference(params, f32_compute):
    cfg_j, cfg_t, pj, pt = params
    prompts = _prompts(cfg_t.vocab)
    ref = JService(cfg_j, pj, f=1, n_slots=4, max_seq=128, seed=0)
    port = ReplicatedLMService(cfg_t, pt, f=1, n_slots=4, max_seq=128,
                               seed=0)
    rids, rticks, rout = _serve(ref, prompts)
    pids, pticks, pout = _serve(port, prompts)
    assert pids == rids == list(range(N_PROMPTS))
    rs, ps = ref.cluster.summary(), port.cluster.summary()
    assert list(ps) == list(rs)
    for k in rs:
        assert (ps[k] == rs[k]
                or (isinstance(rs[k], float) and math.isnan(rs[k])
                    and math.isnan(ps[k]))), k
    assert ps["committed"] == N_PROMPTS + MAX_NEW + N_PROMPTS

    # the port's service equals its own lone engine, token for token
    lone = ServingEngine(cfg_t, pt, n_slots=4, max_seq=128)
    assert _lone(lone, prompts) == pout
    assert port.leader_engine().state_fingerprint() == \
        lone.state_fingerprint() == pticks[-1][2]
    assert [t[:2] for t in pticks] == [t[:2] for t in rticks]

    # the reference's tokens, or a near-tie where they differ
    probe = _GapProbe(cfg_j, pj, n_slots=4, max_seq=128)
    assert _lone(probe, prompts) == rout
    compared = 0
    for s, (mine, theirs) in enumerate(zip(pout, rout)):
        assert len(mine) == len(theirs) == MAX_NEW
        for i, (a, b) in enumerate(zip(mine, theirs)):
            if a != b:
                assert probe.gaps[(s, i)] < NEAR_TIE, (s, i)
                break
            compared += 1
    assert compared >= N_PROMPTS * MAX_NEW // 2

    # every replica executed the same commands into the same engine state
    port.cluster.run_for(0.05)
    fps = {r.sm.engine.state_fingerprint() for r in port.cluster.replicas}
    assert fps == {lone.state_fingerprint()}
    assert all(e.n_steps == N_PROMPTS * (PROMPT_LEN + MAX_NEW)
               for e in port.engines_made)


def test_lm_service_failover(params):
    """The reference's failover check (tests/test_system.py): crash the
    leader, run 0.2 s, ask again -- the results are unchanged and the new
    leader's rebuilt engine re-executed the log."""
    _, cfg_t, _, pt = params
    svc = ReplicatedLMService(cfg_t, pt, f=1, n_slots=2, max_seq=64, seed=3)
    sid = svc.submit_prompt([3, 1, 4], max_new=3)
    for _ in range(3):
        svc.step()
    out_before = svc.result(sid)
    old = svc.cluster.leader_id
    svc.cluster.crash_replica(old)
    svc.cluster.run_for(0.2)
    out_after = svc.result(sid)
    assert svc.cluster.leader_id != old
    assert tuple(out_before) == tuple(out_after) and len(out_after) == 3
    assert len(svc.engines_made) > 3            # rebuilt on the view change
    assert svc.leader_engine().n_steps == 3 + 3
    assert svc.cluster.summary()["view_changes"] == 1


def test_replicated_metadata_log_equals_the_reference():
    def ops(log):
        out = [log.latest_committed()]
        log.commit_manifest(100, 0xABCDEF, "/ckpt/100")
        log.record_scaling_event(100, 7, (2, 4))
        out += [log.latest_committed(), log.current_scaling(),
                log.acquire_shard_lease(3, "host-a"),
                log.acquire_shard_lease(3, "host-b"),
                log.acquire_shard_lease(3, "host-a")]
        log.commit_manifest(200, 0x123, "/ckpt/200")
        out += [log.latest_committed(), log.fast_commit_ratio]
        return out, log.cluster.summary()

    (mine, ms), (theirs, ts) = ops(PLog(f=1, seed=2)), ops(RLog(f=1, seed=2))
    assert mine == theirs
    assert mine[1] == {"step": 100, "hash": 0xABCDEF, "path": "/ckpt/100"}
    assert mine[3:6] == [True, False, True]
    assert ms == ts and ms["committed"] == 14


def test_serve_prints_the_references_consensus_line(monkeypatch, capsys):
    import repro.launch.serve as jserve
    import repro_torch.launch.serve as tserve

    tserve.main(["--device", "cpu", "--prompts", "2", "--max-new", "3"])
    mine = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve", "--prompts", "2",
                                      "--max-new", "3"])
    jserve.main()
    theirs = capsys.readouterr().out.splitlines()
    assert len(mine) == len(theirs) == 1 + 3 + 2 + 1
    assert mine[0] == theirs[0] == \
        "admitted 2 prompts on a 3-replica Nezha group"
    assert mine[-1] == theirs[-1] and mine[-1].startswith("consensus: 7 ")
    for a, b in zip(mine[1:4], theirs[1:4]):    # same shape of tick lines
        assert a.split("(")[0] == b.split("(")[0]


def test_serve_defaults_to_the_card():
    """No fallback: without a card, the default device fails loudly."""
    import repro_torch.launch.serve as tserve

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--prompts", "1", "--max-new", "1"])
