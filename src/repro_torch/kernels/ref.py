"""Oracles for the port's LM and hash kernels.

Port of the attention, SSD and hash parts of `repro/kernels/ref.py`: the
correctness references that the kernel tests hold `flash_attention`,
`ssd_scan` and `inchash` against.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import entry_hash32_torch, prefix_hashes_torch
from repro_torch.models.attention import reference_attention


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """[B, S, H, D] x [B, S, Hk, D]^2 -> [B, S, H, D]."""
    return reference_attention(q, k, v, causal=causal, window=window)


def ssd_scan_ref(x, dt, A, B, C):
    """Sequential SSD recurrence in float32, one step per position (no D
    skip -- the kernel computes the core scan only).

    x: [b,S,H,P], dt: [b,S,H], A: [H], B,C: [b,S,N] -> y [b,S,H,P] in x's
    dtype."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    A = A.float()
    h = torch.zeros(b, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)                           # [b, H]
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dtf[:, t], Bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def inchash_ref(deadline_ns, client_id, request_id):
    """Per-entry 32-bit hashes + prefix XOR folds (fast-reply hashes), as
    int64 tensors holding the 32-bit patterns."""
    h = entry_hash32_torch(deadline_ns, client_id, request_id)
    return h, prefix_hashes_torch(h)


__all__ = ["flash_attention_ref", "ssd_scan_ref", "inchash_ref"]
