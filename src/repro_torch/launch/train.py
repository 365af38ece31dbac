"""Fault-tolerant training driver.

Port of `repro/launch/train.py`. Wires together: data pipeline -> train
step (autograd over the port's model; on the card its attention and SSD
scans launch the hand-written kernels) -> checkpointing through the
Nezha-replicated metadata log -> straggler mitigation via DOM deadlines on
gradient contributions. Runs on ``TrainerConfig.device``: the card unless
the caller asks for the CPU. Two fields of `TrainerConfig` are the
port's own: ``device``, and ``mean_doc_len``, the synthetic documents'
mean length (the reference's stream has 512).

CLI:
  python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --steps 20
  (add --device cpu without a card)
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class TrainerConfig:
    arch: str = "tinyllama-1.1b"
    smoke: bool = True              # reduced config
    steps: int = 20
    batch: int = 8
    seq: int = 128
    microbatches: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    use_metadata_log: bool = True
    straggler_deadline_pctl: float = 95.0   # DOM percentile for grad deadlines
    straggler_sim: bool = False             # simulate per-host timing jitter
    compression: Optional[str] = None
    seed: int = 0
    device: str = "cuda"
    mean_doc_len: int = 512


class Trainer:
    def __init__(self, tc: TrainerConfig):
        from repro_torch.configs import get_config, smoke_config
        from repro_torch.core.dom import DomParams, OwdEstimator
        from repro_torch.data.pipeline import make_host_iterator
        from repro_torch.kernels.ops import resolve_device
        from repro_torch.train.train_step import (
            make_train_state,
            make_train_step,
        )

        self.tc = tc
        self.device = resolve_device(tc.device)
        self.cfg = smoke_config(tc.arch) if tc.smoke else get_config(tc.arch)
        self.state = make_train_state(self.cfg, seed=tc.seed,
                                      device=self.device)
        self.step_fn = make_train_step(
            self.cfg, microbatches=tc.microbatches,
            compression=tc.compression)
        self.data = make_host_iterator(self.cfg.vocab, tc.seq, tc.batch,
                                       seed=tc.seed,
                                       mean_doc_len=tc.mean_doc_len)
        self.step = 0
        self.log = None
        if tc.use_metadata_log:
            from repro_torch.ckpt.replicated_log import ReplicatedMetadataLog

            self.log = ReplicatedMetadataLog(seed=tc.seed)
        # Straggler mitigation: a DOM deadline estimator over simulated
        # per-host gradient-ready times.
        self._owd = OwdEstimator(DomParams(
            percentile=tc.straggler_deadline_pctl, clamp_d=10.0,
            initial_owd=0.5))
        self._rng = np.random.default_rng(tc.seed + 1)
        self.metrics_history: list[dict] = []
        self.straggler_stats = {"steps": 0, "excluded": 0}

    # -- optional restore -------------------------------------------------------
    def maybe_restore(self) -> bool:
        """Restore the latest checkpoint (the log's latest committed one
        when a log is attached) and fast-forward the data pipeline to its
        step; False when there is none."""
        if not self.tc.ckpt_dir:
            return False
        from repro_torch.ckpt.checkpoint import latest_step, load_checkpoint
        from repro_torch.data.pipeline import make_host_iterator

        s = latest_step(self.tc.ckpt_dir, log=self.log)
        if s is None:
            return False
        tree, manifest = load_checkpoint(self.tc.ckpt_dir, s, log=self.log)
        self.state = _state_from_tree(self.state, tree)
        self.step = manifest["step"]
        # fast-forward the data pipeline (deterministic skip)
        self.data = make_host_iterator(self.cfg.vocab, self.tc.seq,
                                       self.tc.batch, seed=self.tc.seed,
                                       start_step=self.step,
                                       mean_doc_len=self.tc.mean_doc_len)
        return True

    # -- one training step -------------------------------------------------------
    def train_step(self) -> dict:
        batch = next(self.data)
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        t0 = time.time()
        if self.tc.straggler_sim:
            # Simulated per-host gradient-ready times: the DOM deadline
            # decides which hosts make the fast aggregation path this step.
            n_hosts = 8
            ready = self._rng.lognormal(np.log(0.08), 0.3, n_hosts)
            ready[self._rng.integers(n_hosts)] *= self._rng.choice(
                [1.0, 1.0, 1.0, 6.0])
            deadline = self._owd.estimate(0.0, 0.0)
            on_time = ready <= deadline
            for r in ready:
                self._owd.record(0.0, r)
            self.straggler_stats["steps"] += 1
            self.straggler_stats["excluded"] += int((~on_time).sum())
            # the masked mean itself happens inside the (sharded) step on
            # real meshes; at host scale the batch gradient stands for it
        self.state, metrics = self.step_fn(self.state, batch)
        metrics = _host_metrics(metrics)
        metrics["step_time_s"] = time.time() - t0
        self.step += 1
        self.metrics_history.append(metrics)

        if self.tc.ckpt_dir and self.step % self.tc.ckpt_every == 0:
            from repro_torch.ckpt.checkpoint import save_checkpoint

            save_checkpoint(self.tc.ckpt_dir, self.step,
                            _tree_of_state(self.state),
                            metadata={"arch": self.cfg.name}, log=self.log)
        return metrics

    def run(self) -> list[dict]:
        self.maybe_restore()
        while self.step < self.tc.steps:
            m = self.train_step()
            if self.step % 5 == 0 or self.step == 1:
                print(f"step {self.step:5d} loss {m['loss']:.4f} "
                      f"gnorm {m.get('grad_norm', 0):.3f} "
                      f"{m['step_time_s']*1e3:.0f}ms", flush=True)
        return self.metrics_history


def _host_metrics(metrics: dict) -> dict:
    """A step's metrics as Python floats, the tensors pulled to the host in
    one copy of a stacked float64 tensor."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().to(torch.float64)
                            for k in keys]).cpu().tolist()
        out.update(zip(keys, vals))
    return out


def _tree_of_state(state) -> dict:
    return {"params": state.params,
            "opt": {"step": state.opt.step, "m": state.opt.m,
                    "v": state.opt.v}}


def _state_from_tree(like, tree):
    """A loaded checkpoint tree as a `TrainState` with ``like``'s types and
    device on every leaf."""
    from repro_torch.ckpt.checkpoint import as_tensor
    from repro_torch.train.optimizer import AdamWState, tree_map
    from repro_torch.train.train_step import TrainState

    def conv(ref, arr):
        return tree_map(lambda r, a: as_tensor(a, r.dtype, r.device), ref,
                        arr)

    step = like.opt.step
    return TrainState(
        params=conv(like.params, tree["params"]),
        opt=AdamWState(step=as_tensor(tree["opt"]["step"], torch.int32,
                                      step.device),
                       m=conv(like.opt.m, tree["opt"]["m"]),
                       v=conv(like.opt.v, tree["opt"]["v"])))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--no-log", action="store_true")
    ap.add_argument("--compression", default=None, choices=[None, "int8"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    tc = TrainerConfig(arch=args.arch, smoke=args.smoke, steps=args.steps,
                       batch=args.batch, seq=args.seq,
                       microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                       use_metadata_log=not args.no_log,
                       compression=args.compression, device=args.device)
    Trainer(tc).run()


if __name__ == "__main__":
    main()
