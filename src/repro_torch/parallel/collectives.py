"""int8-compressed gradient exchange: quantize-dequantize round trip.

Port of the int8 part of `repro/parallel/collectives.py` (lines 76-93):
quantize to int8 with a per-tensor scale (the largest magnitude / 127),
round half to even as `jnp.round` does, clip to [-127, 127]. On one card
there is no collective to shrink; the train step's ``compression="int8"``
applies the round trip to every gradient, as the reference's step does.
The deadline-masked mean, the straggler feedback and the explicit
compressed all-reduce are not ported yet.
"""
from __future__ import annotations

import torch


def int8_quantize(x: torch.Tensor):
    """(q int8, scale float32 0-dim): x / scale rounded half to even."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """The quantize-dequantize round trip, in x's type."""
    q, scale = int8_quantize(x)
    return int8_dequantize(q, scale).to(x.dtype)


__all__ = ["int8_quantize", "int8_dequantize", "int8_compress_decompress"]
