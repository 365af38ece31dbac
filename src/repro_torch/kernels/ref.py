"""Oracles for the port's attention kernel.

Port of the attention part of `repro/kernels/ref.py`: the correctness
reference that the kernel tests hold `flash_attention` against.
"""
from __future__ import annotations

from repro_torch.models.attention import reference_attention


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """[B, S, H, D] x [B, S, Hk, D]^2 -> [B, S, H, D]."""
    return reference_attention(q, k, v, causal=causal, window=window)


__all__ = ["flash_attention_ref"]
