"""Order-preserving 64-bit sort keys for float64 event times.

Port of `repro/kernels/timekeys.py`. The TPU split each time into two int32
words because it lacked a 64-bit integer compare; Hopper compares 64-bit
words natively, so each time is one key:

  bits = bitcast(x, int64)        (+0.0 and -0.0 both take bits 0)
  key  = bits                if bits >= 0
         bits ^ INT64_MAX    if bits <  0

Signed comparison of the keys is the float64 order for non-NaN inputs, and
ties are exactly float64 ties (the TPU keys put -0.0 below +0.0; time values
are never signed zeros, and here the two share a key). Every non-finite
input takes ``KEY_INF``, the key of +inf. ``KEY_TOP`` sorts above every
time key and marks masked or padding lanes.

The CUDA kernels (``csrc/common.cuh``) use the unsigned form of the same
key, ``key ^ INT64_MIN``; unsigned comparison there equals signed
comparison here.
"""
from __future__ import annotations

import torch

INT64_MAX = 0x7FFFFFFFFFFFFFFF
KEY_INF = 0x7FF0000000000000      # key(+inf): bits of +inf, non-negative
KEY_TOP = INT64_MAX               # above every time key


def time_sort_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys of float64 times; signed order == float64 order."""
    if x.dtype != torch.float64:
        raise TypeError(f"time keys need float64 times, got {x.dtype}")
    bits = torch.where(x == 0, 0, x.view(torch.int64))
    key = torch.where(bits < 0, bits ^ INT64_MAX, bits)
    return torch.where(torch.isfinite(x), key, KEY_INF)


__all__ = ["time_sort_keys", "INT64_MAX", "KEY_INF", "KEY_TOP"]
