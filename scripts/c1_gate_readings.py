#!/usr/bin/env python3
"""Readings of phase 14's C1 model gate on one GPU: what it reads on sound
kernels and on kernels made wrong on purpose, so that its limits sit
between the two.

For tinyllama-1.1b (flash_attention) and mamba2-130m (ssd_scan) at full
width, `chip_smoke.c1_gradients` (one step at B 1 x S 512 through the
kernels and through their plain versions, in float32 and bf16 compute)
runs with the gate's token seed and two others, then with the gate's seed
and each kernel's wrapper swapped for a wrong one (the forward wrong, the
backward still the plain version's, as a faulty kernel would be):

  flash_attention: the causal mask off by one (each query also sees the
      next key); q scaled by 1 + 2^-4 before the kernel;
  ssd_scan: dt scaled by 1 + 2^-4; no state handed from chunk to chunk
      (each 128-row chunk scanned from a zero state).

Prints one JSON line a run: the float32 gate's reading (the largest
relative L2 difference of a leaf, kernels vs plain) and the bf16 gate's
(the largest ratio of a leaf's kernels-vs-plain difference to the plain
version's own bf16-vs-float32 difference), each with its leaf; then the
card's name and power limit.

    python3 scripts/c1_gate_readings.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (14, 15, 16)


def _off_by_one(orig):
    def attention(q, k, v, **masks):
        return orig(q, k, v, **{**masks,
                                "q_offset": masks.get("q_offset", 0) + 1})
    return attention


def _q_scaled(orig):
    def attention(q, k, v, **masks):
        return orig((q.float() * 1.0625).to(q.dtype), k, v, **masks)
    return attention


def _dt_scaled(orig):
    def scan(x, dt, A, B, C, **kw):
        return orig(x, dt * 1.0625, A, B, C, **kw)
    return scan


def _no_handoff(orig):
    def scan(x, dt, A, B, C, *, chunk=128):
        b, S = x.shape[:2]
        nc = S // chunk
        y, h = orig(x.reshape(b * nc, chunk, *x.shape[2:]),
                    dt.reshape(b * nc, chunk, -1), A,
                    B.reshape(b * nc, chunk, -1),
                    C.reshape(b * nc, chunk, -1), chunk=chunk)
        return y.reshape(x.shape), h.reshape(b, nc, *h.shape[1:])[:, -1]
    return scan


MUTATIONS = {
    "flash_attention": {"causal mask off by one": _off_by_one,
                        "q scaled by 1 + 2^-4": _q_scaled},
    "ssd_scan": {"dt scaled by 1 + 2^-4": _dt_scaled,
                 "no state handoff between chunks": _no_handoff},
}


def summary(r: dict) -> dict:
    ratio = {k: r["bf16"][k] / max(r["witness"][k], 1e-30)
             for k in r["bf16"]}
    f32 = max(r["float32"], key=r["float32"].get)
    bf16 = max(ratio, key=ratio.get)
    return {"float32_max_rel_l2": r["float32"][f32], "float32_leaf": f32,
            "bf16_max_ratio": ratio[bf16], "bf16_leaf": bf16,
            "bf16_rel_l2": r["bf16"][bf16],
            "bf16_witness": r["witness"][bf16],
            "witness_range": [min(r["witness"].values()),
                              max(r["witness"].values())]}


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("c1_gate_readings needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build.build_all()
    mods = cs.kernel_modules()
    for name, kernel in cs.TRAIN_ARCHS.items():
        for seed in SEEDS:
            cs.C1_SEED = seed
            r = summary(cs.c1_gradients(dev, name))
            print(json.dumps({"model": name, "kernel": "sound",
                              "seed": seed, **r}), flush=True)
        cs.C1_SEED = SEEDS[0]
        orig = getattr(mods[kernel], f"{kernel}_cuda")
        for label, wrong in MUTATIONS[kernel].items():
            setattr(mods[kernel], f"{kernel}_cuda", wrong(orig))
            try:
                r = summary(cs.c1_gradients(dev, name))
            finally:
                setattr(mods[kernel], f"{kernel}_cuda", orig)
            print(json.dumps({"model": name, "kernel": label,
                              "seed": SEEDS[0], **r}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
