"""Gradients of the kernels whose outputs carry no graph of their own.

A CUDA wrapper writes its outputs through ctypes, so autograd cannot see
into it. `flash_attention` and `ssd_scan` wrap their kernels in an
autograd Function whose backward is the plain version's; these are the
two helpers both Functions share. The reference has no backward kernel
either: its gradients are jnp autodiff of the same functions.
"""
from __future__ import annotations

import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call on ``tensors`` is recorded by autograd: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_grads(plain, saved, grad_outs, kwargs) -> tuple:
    """Gradients of ``plain(*saved, **kwargs)`` with respect to each saved
    input that requires grad (None for the others), given the gradients of
    its outputs: autograd of the plain version, recomputed on fresh leaves."""
    leaves = [t.detach().requires_grad_(t.requires_grad) for t in saved]
    with torch.enable_grad():
        out = plain(*leaves, **kwargs)
        wanted = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad_outs))
    return tuple(next(got) if t.requires_grad else None for t in leaves)


__all__ = ["needs_grad", "plain_grads"]
