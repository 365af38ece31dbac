"""GQA attention: prefill through the flash-attention kernel, decode against
a padded KV cache, and the dense oracle.

Port of `repro/models/attention.py`. The reference's `flash_attention` is
the jnp twin of its Pallas kernel, and `repro/kernels/ops.py::attention`
puts the kernel in its place on a TPU; here `flash_attention` goes through
`repro_torch.kernels.ops.attention`, so every prefill attention launches
the hand-written CUDA kernel on the card and runs the kernel's plain
version on the CPU. `decode_attention` is plain torch: the reference has
no kernel for it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF


def flash_attention(q: torch.Tensor,          # [B, Sq, Hq, D]
                    k: torch.Tensor,          # [B, Sk, Hk, D]
                    v: torch.Tensor,          # [B, Sk, Hk, D]
                    *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention; GQA via head groups. Query position i sits
    at i + q_offset and attends key positions <= i + q_offset when causal."""
    return ops.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def decode_attention(q: torch.Tensor,         # [B, 1, Hq, D]
                     k_cache: torch.Tensor,   # [B, Smax, Hk, D]
                     v_cache: torch.Tensor,
                     cur_len,                 # int or [B]: valid cache slots
                     *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a padded KV cache."""
    B, Smax, Hk, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hk
    scale = 1.0 / (D ** 0.5)
    qh = (q.float() * scale).reshape(B, Hk, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qh, k_cache.float())
    pos = torch.arange(Smax, device=q.device)[None, :]
    if isinstance(cur_len, int):
        cur = cur_len              # a Python int: no host-to-card copy
    else:
        cur = torch.as_tensor(cur_len, device=q.device).reshape(-1, 1)
    mask = pos < cur                                    # [1 or B, Smax]
    if window is not None:
        mask &= pos >= cur - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def reference_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """O(S^2) oracle: softmax over the masked scores (a row with no visible
    key spreads evenly, as the reference's oracle does)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    G = Hq // Hk
    qh = q.reshape(B, Sq, Hk, G, D).float() / (D ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float())
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


__all__ = ["flash_attention", "decode_attention", "reference_attention"]
