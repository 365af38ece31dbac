"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060].

Port of `repro/models/ssm.py`. Prefill runs the chunked SSD scan, whose
core goes through `kernels.ops.ssd_scan` (the hand-written kernel on the
card, its plain version on the CPU); the reference's model calls its jnp
`ssd_chunked` there and reaches its Pallas kernel only through
`repro.kernels.ops.ssd_scan`. Decode is O(1) per token:
h' = h * exp(A dt) + dt * B (x)^T;  y = C h' + D x.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD.

    x:  [b, S, H, P]   inputs per head
    dt: [b, S, H]      positive step sizes (softplus applied by caller)
    A:  [H]            negative decay rates
    B:  [b, S, N]      input projections (single group, broadcast over heads)
    C:  [b, S, N]      output projections
    D:  [H]            skip connection
    Returns (y [b, S, H, P], h_final [b, H, N, P]).
    """
    y, h_final = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    y = y + x * D.to(x.dtype)[None, None, :, None]
    return y, h_final


def ssd_decode_step(h, x, dt, A, B, C, D):
    """One-token SSD update.

    h: [b, H, N, P]; x: [b, H, P]; dt: [b, H]; B, C: [b, N].
    Returns (y [b, H, P], h').
    """
    dt = dt.float()
    decay = torch.exp(dt * A.float())                              # [b, H]
    inc = torch.einsum("bh,bn,bhp->bhnp", dt, B.float(), x.float())
    h_new = h * decay[:, :, None, None] + inc
    y = torch.einsum("bn,bhnp->bhp", C.float(), h_new)
    y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), h_new


def causal_conv1d(x, w, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [b, S, Ch]; w: [W, Ch].

    With `cache` ([b, W-1, Ch]) performs the streaming update (decode) and
    returns (y, new_cache); otherwise pads with zeros (prefill). The W
    products are summed in order in x's dtype, as the reference does."""
    W = w.shape[0]
    if cache is not None:
        xx = torch.cat([cache, x], dim=1)                  # [b, W-1+S, Ch]
        new_cache = xx[:, -(W - 1):, :]
    else:
        xx = F.pad(x, (0, 0, W - 1, 0))
        new_cache = None
    S = x.shape[1]
    y = sum(xx[:, u:u + S, :] * w[u].to(x.dtype) for u in range(W))
    return y, new_cache


def mamba_param_shapes(d_model: int, *, expand: int, headdim: int,
                       n_state: int, conv_width: int) -> dict:
    d_inner = expand * d_model
    H = d_inner // headdim
    conv_ch = d_inner + 2 * n_state
    return {
        "in_proj": (d_model, 2 * d_inner + 2 * n_state + H),  # z, xBC, dt
        "conv_w": (conv_width, conv_ch),
        "dt_bias": (H,),
        "A_log": (H,),
        "D": (H,),
        "out_norm": (d_inner,),
        "out_proj": (d_inner, d_model),
    }


def mamba_mixer(x, p, *, expand: int, headdim: int, n_state: int, chunk: int,
                cache: Optional[dict] = None, return_cache: bool = False):
    """Full Mamba2 block mixer. x: [b, S, d_model].

    cache (decode): {"h": [b,H,N,P], "conv": [b,W-1,conv_ch]}.
    return_cache (prefill): also build the decode cache from this call.
    Returns (y [b,S,d_model], new_cache or None).
    """
    b, S, d_model = x.shape
    d_inner = expand * d_model
    H = d_inner // headdim
    P = headdim
    N = n_state

    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + d_inner + 2 * N]
    dt_raw = zxbcdt[..., -H:]

    xBC_raw = xBC
    conv_cache = cache["conv"] if cache is not None else None
    xBC, new_conv = causal_conv1d(xBC, p["conv_w"], conv_cache)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs = xBC[..., :d_inner].reshape(b, S, H, P)
    B = xBC[..., d_inner:d_inner + N]
    C = xBC[..., d_inner + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if cache is None:
        y, h_final = ssd_chunked(xs, dt, A, B, C, p["D"], chunk=chunk)
        new_cache = None
        if return_cache:
            W = p["conv_w"].shape[0]
            new_cache = {"h": h_final, "conv": xBC_raw[:, -(W - 1):, :]}
    else:
        y1, h_new = ssd_decode_step(cache["h"], xs[:, 0], dt[:, 0], A,
                                    B[:, 0], C[:, 0], p["D"])
        y = y1[:, None]
        new_cache = {"h": h_new, "conv": new_conv}

    y = y.reshape(b, S, d_inner)
    # gated output norm (mamba2 uses RMSNorm(y * silu(z)))
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["out_norm"])
    return torch.matmul(y, p["out_proj"].to(x.dtype)), new_cache


__all__ = ["ssd_chunked", "ssd_decode_step", "causal_conv1d", "mamba_mixer",
           "mamba_param_shapes"]
