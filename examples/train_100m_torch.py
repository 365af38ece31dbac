"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps, with a kill-and-restore drill halfway.

Port of `examples/train_100m.py` onto `repro_torch`: deterministic data
pipeline (the trainer's own, with documents of mean length 16,
`MEAN_DOC_LEN`, in place of 512) -> train step (AdamW, remat,
microbatching; on the card every attention launches the hand-written
flash-attention kernel) -> checkpoints every 50 steps committed through
the Nezha-replicated metadata log -> at the halfway step a new `Trainer` (the restarted job) restores from the
log's latest committed checkpoint. The metadata log is a service of its
own (its replicas outlive the training job), so the new trainer is handed
the same log; the drill checks that it restores at the halfway step, that
the restored manifest is the one the log committed, and that every leaf
of the restored state equals the saved one bit for bit; then it trains on
(its data fast-forwarded by its own restore) and the loss must fall.

Run:  PYTHONPATH=src python examples/train_100m_torch.py --steps 200
      (on the card; add --device cpu without one -- minutes per step there)
"""
import argparse
import dataclasses
import shutil
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, register
from repro_torch.launch.train import Trainer, TrainerConfig, _tree_of_state
from repro_torch.models.model import count_params
from repro_torch.train.optimizer import tree_leaves

DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / "train100m_ckpt"
# Documents of mean length 16: the synthetic tokens are i.i.d. uniform
# within a document, so the EOS separators are all there is to learn. At
# the pipeline's default length (512) the loss floor, ln(vocab - 1), lies
# ~0.004 below a random init's loss, and 200 steps of noise gradients
# move the loss up, the reference's trainer's as the port's
# (`scripts/drill_loss_witness.py`); with an EOS every ~17 tokens the
# floor is ~0.39 lower, so a working trainer's loss falls.
MEAN_DOC_LEN = 16


def config_100m():
    """~100M parameters: tinyllama's layout cut to 8 layers x 512 wide, its
    32k vocabulary."""
    base = get_config("tinyllama-1.1b")
    return dataclasses.replace(
        base, name="repro-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32000, max_seq=2048)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _train_to(trainer: Trainer, steps: int, quiet: bool) -> float:
    """Train until ``steps`` (printing every 5 steps unless ``quiet``);
    returns the wall seconds."""
    trainer.tc = dataclasses.replace(trainer.tc, steps=steps)
    _sync(trainer.device)
    t0 = time.perf_counter()
    if quiet:
        while trainer.step < steps:
            trainer.train_step()
    else:
        trainer.run()
    _sync(trainer.device)
    return time.perf_counter() - t0


def run_drill(steps: int = 200, batch: int = 8, seq: int = 256,
              ckpt: str = str(DEFAULT_CKPT), device: str = "cuda",
              quiet: bool = False) -> dict:
    """The drill; returns what it saw (losses, the restore, walls). Raises
    when the restore is wrong or the loss did not fall."""
    from repro_torch.ckpt.checkpoint import load_checkpoint

    shutil.rmtree(ckpt, ignore_errors=True)
    cfg100 = config_100m()
    register(cfg100)
    tc = TrainerConfig(arch=cfg100.name, smoke=False, steps=steps,
                       batch=batch, seq=seq, ckpt_dir=ckpt, ckpt_every=50,
                       microbatches=2, device=device,
                       mean_doc_len=MEAN_DOC_LEN)
    if not quiet:
        print(f"training {cfg100.name}: {count_params(cfg100)/1e6:.1f}M "
              f"params, {steps} steps of {batch}x{seq} tokens on {device}")
    # phase 1: half the run, then simulate a crash (process restart)
    t = Trainer(tc)
    half = steps // 2
    first_half_s = _train_to(t, half, quiet)
    if not quiet:
        print(f"-- simulated job kill at step {t.step}; restarting from "
              f"checkpoints --")
    t2 = Trainer(tc)
    t2.log = t.log           # the metadata log outlives the training job
    t0 = time.perf_counter()
    restored = t2.maybe_restore()
    restore_s = time.perf_counter() - t0
    committed = t2.log.latest_committed()
    _, manifest = load_checkpoint(ckpt, t2.step, verify=False)
    if not (restored and t2.step == half and committed is not None
            and committed["step"] == half
            and committed["hash"] == manifest["integrity_hash"]):
        raise RuntimeError(f"restore failed: restored={restored} at step "
                           f"{t2.step}, log {committed}, manifest hash "
                           f"{manifest['integrity_hash']}")
    saved = tree_leaves(_tree_of_state(t.state))
    loaded = tree_leaves(_tree_of_state(t2.state))
    if not (len(saved) == len(loaded) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(saved, loaded))):
        raise RuntimeError("the restored state differs from the saved one")
    if not quiet:
        print(f"restored={restored} at step {t2.step} (metadata log "
              f"agrees: {committed})")
    losses = [m["loss"] for m in t.metrics_history]
    del t, saved, loaded
    second_half_s = _train_to(t2, steps, quiet)
    losses += [m["loss"] for m in t2.metrics_history]
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    return {"params": count_params(cfg100), "restored_at": half,
            "log_committed": committed, "losses": losses,
            "first_half_s": first_half_s, "second_half_s": second_half_s,
            "restore_s": restore_s}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda", help="cuda (the default) "
                    "or cpu")
    args = ap.parse_args()
    r = run_drill(args.steps, args.batch, args.seq, args.ckpt, args.device)
    print(f"loss: {r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}")
    print("train_100m_torch OK")


if __name__ == "__main__":
    main()
