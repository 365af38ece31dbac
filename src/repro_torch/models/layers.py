"""Composable layers on torch tensors: norms, RoPE, MLPs, embeddings.

Port of `repro/models/layers.py`. Parameters are plain nested dicts of
float32 tensors; compute happens in bf16 (`CDT`), with the float32 casts
where the reference has them. Layer-stacked parameters carry a leading
[n_layers] axis; `transformer.py` walks it with a Python loop.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

CDT = torch.bfloat16  # compute dtype


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(x: torch.Tensor, p: dict, kind: str):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# rotary embeddings (full, partial, and chatglm-style 2d == half-rotary)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, rope_frac: float, theta: float, device=None):
    """Inverse frequencies, computed in float64 numpy and stored float32.
    Cached per device, so a forward pass copies them to the card once, not
    twice a layer (each host-to-card copy waits for the card)."""
    rot = int(head_dim * rope_frac) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return torch.as_tensor(inv.astype(np.float32), device=device), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               rope_frac: float = 1.0, theta: float = 10000.0):
    """x: [..., S, H, D]; positions: [..., S] int. Interleaved pairs
    (x[0::2], x[1::2]) rotate; dims past the rotary fraction pass through."""
    D = x.shape[-1]
    inv, rot = rope_freqs(D, rope_frac, theta, device=x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv          # [..., S, rot/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    sin = sin[..., :, None, :]                            # broadcast over heads
    cos = cos[..., :, None, :]
    xr = x[..., :rot]
    xp = x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def swiglu(x: torch.Tensor, p: dict):
    g = torch.matmul(x, p["w_gate"].to(x.dtype))
    u = torch.matmul(x, p["w_up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, p["w_down"].to(x.dtype))


def gelu_mlp(x: torch.Tensor, p: dict):
    h = torch.matmul(x, p["w_up"].to(x.dtype))
    if "b_up" in p:
        h = h + p["b_up"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = torch.matmul(h, p["w_down"].to(x.dtype))
    if "b_down" in p:
        y = y + p["b_down"].to(x.dtype)
    return y


def apply_mlp(x: torch.Tensor, p: dict, kind: str):
    return swiglu(x, p) if kind == "swiglu" else gelu_mlp(x, p)


def mlp_param_shapes(d: int, f: int, kind: str) -> dict:
    if kind == "swiglu":
        return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return {"w_up": (d, f), "b_up": (f,), "w_down": (f, d), "b_down": (d,)}


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
def embed(tokens: torch.Tensor, table: torch.Tensor):
    return table[tokens].to(CDT)


def unembed(x: torch.Tensor, table: torch.Tensor):
    return torch.matmul(x, table.to(x.dtype).t())


__all__ = [
    "CDT",
    "rms_norm",
    "layer_norm",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
    "swiglu",
    "gelu_mlp",
    "apply_mlp",
    "mlp_param_shapes",
    "embed",
    "unembed",
]
