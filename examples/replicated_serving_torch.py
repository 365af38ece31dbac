"""Replicated LM serving on the PyTorch port: three model replicas behind
Nezha.

Admission commands flow through DOM-ordered consensus, so every replica
forms identical batches and (greedy) decodes identical tokens -- a client
can fail over to any replica mid-generation. This is the paper's RSM story
with the state machine being an LM serving engine.

The port of examples/replicated_serving.py: the consensus runs on the host
(the event-driven `nezha` backend), the model and its engines on
``--device`` (the card unless the caller asks for the CPU).

Run:  PYTHONPATH=src python examples/replicated_serving_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.models.model import init_params
from repro_torch.serving.engine import ReplicatedLMService


def main(device="cuda") -> dict:
    cfg = smoke_config("tinyllama-1.1b")
    params = init_params(cfg, 0, device=device)
    svc = ReplicatedLMService(cfg, params, f=1, n_slots=4, max_seq=96, seed=0)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=5).tolist() for _ in range(3)]
    ids = [svc.submit_prompt(p, max_new=6) for p in prompts]
    print(f"admitted {len(ids)} prompts across 3 replicas (consensus-ordered)")

    fingerprints = []
    for step in range(6):
        kind, n, fp = svc.step()
        fingerprints.append(fp)
        print(f"  decode tick {step}: {n} tokens, state fingerprint {fp & 0xFFFFFFFF:08x}")

    outputs = {}
    for sid in ids:
        outputs[sid] = list(svc.result(sid))
        print(f"  seq {sid}: generated {outputs[sid]}")

    # replicas agree: compare every live replica engine's fingerprint
    fps = {rid: r.sm.engine.state_fingerprint()
           for rid, r in enumerate(svc.cluster.replicas) if r.alive}
    # followers only execute up to the commit point; compare synced prefixes
    print(f"replica state fingerprints: { {k: v & 0xFFFFFFFF for k, v in fps.items()} }")
    lead = svc.cluster.leader_id
    logs = {rid: [e.uid for e in r.synced] for rid, r in enumerate(svc.cluster.replicas)}
    m = min(len(v) for v in logs.values())
    assert all(v[:m] == logs[lead][:m] for v in logs.values()), "log divergence!"
    print(f"consensus logs agree on a {m}-command prefix across all replicas")
    return outputs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
