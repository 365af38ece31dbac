"""Port of `repro/launch/serve.py`: the serving driver -- a replicated LM
service behind Nezha at the smoke size of ``--arch``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --prompts 4

The engines run on ``--device`` (the card by default; ``--device cpu``
asks for the CPU). The weights are random, from seed 0.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--prompts", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ReplicatedLMService

    cfg = smoke_config(args.arch)
    params = init_params(cfg, 0, device=args.device)
    svc = ReplicatedLMService(cfg, params, f=args.f,
                              n_slots=max(args.prompts, 2), max_seq=128)
    rng = np.random.default_rng(0)
    ids = [svc.submit_prompt(rng.integers(1, cfg.vocab, 4).tolist(),
                             max_new=args.max_new) for _ in range(args.prompts)]
    print(f"admitted {len(ids)} prompts on a {2*args.f+1}-replica Nezha group")
    for t in range(args.max_new):
        _, n, fp = svc.step()
        print(f"tick {t}: {n} tokens (state {fp & 0xFFFFFFFF:08x})")
    for sid in ids:
        print(f"seq {sid}: {list(svc.result(sid))}")
    s = svc.cluster.summary()
    print(f"consensus: {s['committed']} commands, fast-path {s['fast_commit_ratio']:.0%}, "
          f"median commit {s['median_latency']*1e6:.0f}us")


if __name__ == "__main__":
    main()
