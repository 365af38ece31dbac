#!/usr/bin/env python3
"""Does the 100M drill's loss fall on the trainer's default data? The
reference's trainer and the port's, side by side on the CPU.

Both trainers run the drill's schedule (`examples/train_100m.py`: 200
steps of 8 x 256 tokens, microbatches 2, the trainers' defaults: AdamW,
remat "full", bf16 compute, seed 0) on a narrowed copy of its model
(tinyllama's layout at ``--layers`` x ``--width``, the drill's 32k
vocabulary), once on the synthetic documents of the pipeline's default
mean length (512) and once on documents of mean length 16 (the port's
drill, `examples/train_100m_torch.py`). Both start from the same state:
the reference's initial one, written to ``build/drill_witness`` (removed
at the end) and carried into the port (`train_state_from_reference`). Each (package,
length) runs in a process of its own, the reference's two first; the
reference's processes import JAX only, the port's torch only. Prints one
JSON line a run (the loss at step 1 and every 25 steps, and the first and
last) and the last line's verdict for each.

    PYTHONPATH=src python3 scripts/drill_loss_witness.py [--steps 200]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STATE = ROOT / "build" / "drill_witness" / "initial_state.npz"
DOC_LENS = (512, 16)


def narrowed(get_config, layers: int, width: int):
    """The drill's model (`config_100m`) at ``layers`` x ``width``."""
    base = get_config("tinyllama-1.1b")
    return dataclasses.replace(
        base, name="repro-100m-narrow", n_layers=layers, d_model=width,
        n_heads=max(width // 64, 1), n_kv_heads=1, head_dim=64,
        d_ff=4 * width, vocab=32000, max_seq=2048)


def run_reference(args) -> list:
    from repro.configs import get_config, register
    from repro.data.pipeline import DataConfig, SyntheticTokenDataset
    from repro.launch.train import Trainer, TrainerConfig

    cfg = narrowed(get_config, args.layers, args.width)
    register(cfg)
    tc = TrainerConfig(arch=cfg.name, smoke=False, steps=args.steps,
                       batch=8, seq=256, microbatches=2,
                       use_metadata_log=False)
    t = Trainer(tc)
    if args.doc == DOC_LENS[0]:
        import jax
        import numpy as np

        STATE.parent.mkdir(parents=True, exist_ok=True)
        leaves = jax.tree_util.tree_leaves_with_path(
            {"params": t.state.params, "m": t.state.opt.m,
             "v": t.state.opt.v, "step": t.state.opt.step})
        np.savez(STATE, **{jax.tree_util.keystr(p): np.asarray(a)
                           for p, a in leaves})
    # the reference's TrainerConfig has no document length: its stream,
    # rebuilt with the one asked for
    t.data = SyntheticTokenDataset(DataConfig(
        vocab=cfg.vocab, seq_len=tc.seq, global_batch=tc.batch,
        seed=tc.seed, mean_doc_len=args.doc)).at_step(0)
    return [m["loss"] for m in _quiet(t.run)]


def run_port(args) -> list:
    import re
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.configs import get_config, register
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.models.model import train_state_from_reference

    cfg = narrowed(get_config, args.layers, args.width)
    register(cfg)
    t = Trainer(TrainerConfig(arch=cfg.name, smoke=False, steps=args.steps,
                              batch=8, seq=256, microbatches=2,
                              use_metadata_log=False, device="cpu",
                              mean_doc_len=args.doc))
    tree: dict = {}
    with np.load(STATE) as saved:
        for key in saved.files:                 # "['params']['embed']"
            *path, last = re.findall(r"\['([^']+)'\]", key)
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[last] = saved[key]
    t.state = train_state_from_reference(SimpleNamespace(
        params=tree["params"], opt=SimpleNamespace(
            m=tree["m"], v=tree["v"], step=tree["step"])), device="cpu")
    return [m["loss"] for m in _quiet(t.run)]


def _quiet(run):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return run()


def worker(args) -> None:
    losses = (run_reference if args.side == "reference" else run_port)(args)
    marks = [1] + list(range(25, len(losses) + 1, 25))
    print(json.dumps({"side": args.side, "mean_doc_len": args.doc,
                      "losses_at": {s: losses[s - 1] for s in marks},
                      "first": losses[0], "last": losses[-1]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--threads", type=int, default=2,
                    help="torch's CPU threads a process")
    ap.add_argument("--side", choices=("reference", "port"))
    ap.add_argument("--doc", type=int)
    args = ap.parse_args()
    if args.side:
        worker(args)
        return 0
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": str(args.threads),
           "PYTHONPATH": str(ROOT / "src")}
    rows = []
    for side in ("reference", "port"):
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--side", side, "--doc", str(doc),
             "--steps", str(args.steps), "--layers", str(args.layers),
             "--width", str(args.width)], env=env, stdout=subprocess.PIPE,
            text=True) for doc in DOC_LENS]
        for p in procs:
            out, _ = p.communicate()
            if p.returncode:
                return p.returncode
            rows.append(json.loads(out.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    STATE.unlink()
    print(json.dumps({f"{r['side']} {r['mean_doc_len']}": (
        "falls" if r["last"] < r["first"] else "does not fall")
        for r in rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
