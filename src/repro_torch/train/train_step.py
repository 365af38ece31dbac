"""Train-step construction: loss + gradients + AdamW, microbatch
accumulation, optional int8-compressed gradients.

Port of `repro/train/train_step.py`. The reference's step is a pure
function for `jax.jit`; here it is autograd over the port's model
functions: the parameters enter as fresh leaves that require grad, and
`torch.autograd.grad` of the loss gives their gradients (zeros for a leaf
the loss does not read, as `jax.grad` gives). On the card every attention
and SSD scan of the forward -- and of its recompute under the config's
activation checkpointing -- launches the hand-written kernels; their
backward is the plain versions' (`kernels.flash_attention`,
`kernels.ssd_scan`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.model import abstract_params, init_params, make_loss_fn
from repro_torch.train.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_lr,
    tree_leaves,
    tree_map,
)


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState


def make_train_state(cfg: ArchConfig, seed: Optional[int] = None, *,
                     device="cuda") -> TrainState:
    """Real state (`init_params` from ``seed`` on ``device``, zero moments)
    or, with no seed, the abstract state: meta tensors of every leaf's
    shape and type. The moments are bf16 for a config whose
    ``optimizer_dtype`` says so, else float32."""
    dt = torch.bfloat16 if cfg.optimizer_dtype == "bfloat16" \
        else torch.float32
    if seed is None:
        params = abstract_params(cfg)
        meta = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
        opt = AdamWState(step=torch.empty((), dtype=torch.int32,
                                          device="meta"),
                         m=tree_map(meta, params), v=tree_map(meta, params))
        return TrainState(params=params, opt=opt)
    params = init_params(cfg, seed, device=resolve_device(device))
    return TrainState(params=params, opt=adamw_init(params, dt))


def _split(batch: dict, n: int) -> list:
    """``n`` microbatches of the leading axis (each leaf [B, ...] ->
    [B / n, ...])."""
    parts = {k: torch.as_tensor(v).chunk(n, dim=0) for k, v in batch.items()}
    if any(len(p) != n or p[0].shape[0] * n != len(batch[k])
           for k, p in parts.items()):
        raise ValueError(f"the batch does not split into {n} equal "
                         f"microbatches")
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def make_train_step(cfg: ArchConfig, *, microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000,
                    compression: Optional[str] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches > 1`` splits the batch on the leading axis and sums the
    microbatches' gradients in float32 before dividing by their count (the
    reference's `lax.scan` accumulation); metrics then hold only the mean
    "loss". ``compression="int8"`` passes every gradient through
    `int8_compress_decompress`. Metrics also hold "lr" (the schedule at
    the state's step) and "grad_norm" (before clipping), as 0-dim
    tensors."""
    if compression not in (None, "int8"):
        raise ValueError(f"compression must be None or 'int8', not "
                         f"{compression!r}")
    loss_fn = make_loss_fn(cfg)

    def grads_of(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(leaves, batch)
            flat = tree_leaves(leaves)
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(flat, got)])
        return loss.detach(), metrics, tree_map(lambda _: next(grads),
                                                params)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        if microbatches > 1:
            loss_sum, grads = None, None
            for mb in _split(batch, microbatches):
                loss, _, g = grads_of(params, mb)
                if grads is None:
                    loss_sum = loss
                    grads = tree_map(lambda x: x.to(torch.float32), g)
                else:
                    loss_sum = loss_sum + loss
                    grads = tree_map(lambda a, x: a.add_(x), grads, g)
                del g
            loss = loss_sum / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {"loss": loss}
        else:
            loss, metrics, grads = grads_of(params, batch)
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}

        if compression == "int8":
            from repro_torch.parallel.collectives import (
                int8_compress_decompress,
            )

            grads = tree_map(int8_compress_decompress, grads)

        lr = cosine_lr(state.opt.step, peak=peak_lr, warmup=warmup,
                       total=total_steps)
        new_params, new_opt, gnorm = adamw_update(params, grads, state.opt,
                                                  lr=lr)
        metrics = dict(metrics)
        metrics.update(lr=lr, grad_norm=gnorm)
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


__all__ = ["TrainState", "make_train_state", "make_train_step"]
