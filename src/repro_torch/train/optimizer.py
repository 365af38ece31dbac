"""AdamW + global-norm clipping + cosine schedule on torch tensors.

Port of `repro/train/optimizer.py`. Parameter and moment trees are nested
dicts of tensors; the moments' type is configurable (bf16 for the 480B
config). All arithmetic is float32, as in the reference: the bias
corrections are float32 powers of the float32 step, the schedule's cosine
and warmup test are float32, and the update is applied in float32 and
cast back to each leaf's type.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: dict              # tree like params
    v: dict


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (the parameter trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def adamw_init(params: dict, dtype=F32) -> AdamWState:
    """Zero moments of type ``dtype`` shaped like ``params``, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_lr(step: torch.Tensor, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor_frac * peak`` at ``total``; a float32 scalar tensor (0 at
    step 0)."""
    s = step.to(F32)
    warm = peak * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    frac = torch.tensor(floor_frac, dtype=s.dtype, device=s.device)
    cos = peak * (frac + (1 - frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sq = [torch.sum(torch.square(g.to(F32))) for g in tree_leaves(tree)]
    total = sq[0]
    for x in sq[1:]:
        total = total + x
    return torch.sqrt(total)


def adamw_update(params: dict, grads: dict, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step after clipping the gradients to ``clip_norm`` by
    their global norm. Returns (new_params, new_state, grad_norm); the
    inputs are not modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    sf = step.to(F32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=sf.device), sf)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m_new = b1 * m.to(F32) + (1 - b1) * g
        v_new = b2 * v.to(F32) + (1 - b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) \
            + weight_decay * p.to(F32)
        p_new = p.to(F32) - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2)), gnorm


__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm"]
