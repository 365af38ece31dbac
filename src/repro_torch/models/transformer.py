"""LM assembly for the dense family (attention + MLP blocks) and the SSM
family (Mamba2 mixer blocks).

Port of `repro/models/transformer.py`, dense and ssm families:
tinyllama-1.1b and the other dense configs without a sliding window
(granite, chatglm3, qwen2), and mamba2-130m. Parameters are stacked with a
leading [n_layers] axis, as in the reference; `decoder_forward` walks the
layers with a Python loop (no activation checkpointing: the port runs
forward passes only). Prefill attention goes through the flash-attention
kernel and the SSM prefill scan through the SSD-scan kernel; decode
attends to the KV cache, which `self_attention` updates in place.

The MoE, hybrid and encoder-decoder families, sliding windows and modality
frontends are not ported yet: `check_supported` refuses them.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    embed,
    mlp_param_shapes,
    unembed,
)


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what the port's model does not run."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the 'dense' and 'ssm' families only, "
            f"not {cfg.family!r} (MoE, hybrid and audio wait for later "
            f"slices)")
    for flag, value in (("enc_dec", cfg.enc_dec), ("frontend", cfg.frontend),
                        ("window", cfg.window)):
        if value:
            raise NotImplementedError(
                f"{cfg.name}: {flag}={value!r} is not ported yet")


# ---------------------------------------------------------------------------
# parameter shape construction
# ---------------------------------------------------------------------------
def _norm_shapes(d: int, kind: str) -> dict:
    return {"scale": (d,)} if kind == "rms" else {"scale": (d,), "bias": (d,)}


def attn_param_shapes(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out = {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    if cfg.qkv_bias:
        out.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                   bv=(cfg.n_kv_heads * hd,))
    return out


def block_param_shapes(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    d = cfg.d_model
    if cfg.family == "ssm":
        return {
            "norm_m": _norm_shapes(d, cfg.norm),
            "mamba": ssm_mod.mamba_param_shapes(
                d, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                n_state=cfg.ssm_state, conv_width=cfg.conv_width),
        }
    return {
        "ln1": _norm_shapes(d, cfg.norm),
        "attn": attn_param_shapes(cfg),
        "ln2": _norm_shapes(d, cfg.norm),
        "mlp": mlp_param_shapes(d, cfg.d_ff, cfg.mlp),
    }


def param_shapes(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    shapes: dict = {"embed": (cfg.vocab, d)}
    if cfg.pos == "learned":
        shapes["pos_embed"] = (cfg.max_seq, d)
    shapes["layers"] = {k: _stack(v, cfg.n_layers) for k, v in
                        block_param_shapes(cfg).items()}
    shapes["final_norm"] = _norm_shapes(d, cfg.norm)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.vocab, d)
    return shapes


def _stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return (n,) + tuple(tree)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked [n_layers, ...] tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _project_qkv(x: torch.Tensor, p: dict, cfg: ArchConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"].to(x.dtype))
    k = torch.matmul(x, p["wk"].to(x.dtype))
    v = torch.matmul(x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def self_attention(x: torch.Tensor, p: dict, cfg: ArchConfig,
                   positions: torch.Tensor, *, cache=None, cache_len=None):
    """Returns (attn_out_preWo [b, s, Hq*hd], (k, v) or the updated cache).

    With a cache, this step's K/V are written into EVERY batch row at the
    one position ``cache_len`` (clamped so the write fits, as
    `dynamic_update_slice` clamps), in place, and the query attends the
    first ``cache_len + s`` cache positions. This is the reference's
    behaviour: a continuous-batching engine that steps one slot also
    overwrites the other slots' cache at that position."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    if cfg.pos in ("rope", "rope2d"):
        q = apply_rope(q, positions, cfg.rope_frac, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_frac, cfg.rope_theta)
    if cache is None:
        o = attn.flash_attention(q, k, v, causal=True, window=cfg.window)
        new_kv = (k, v)
    else:
        k_cache, v_cache = cache
        idx = int(cache_len)
        at = min(max(idx, 0), k_cache.shape[1] - s)
        k_cache[:, at:at + s] = k.to(k_cache.dtype)
        v_cache[:, at:at + s] = v.to(v_cache.dtype)
        o = attn.decode_attention(q, k_cache, v_cache, idx + s,
                                  window=cfg.window)
        new_kv = (k_cache, v_cache)
    return o.reshape(b, s, -1), new_kv


def dense_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                positions: torch.Tensor, *, cache=None, cache_len=None):
    """Returns (x, new_cache) -- new_cache {"kv": ...} when decoding."""
    h = apply_norm(x, p["ln1"], cfg.norm)
    ao, kv = self_attention(h, p["attn"], cfg, positions,
                            cache=None if cache is None else cache["kv"],
                            cache_len=cache_len)
    x = x + torch.matmul(ao, p["attn"]["wo"].to(x.dtype))
    new_cache = {} if cache is None else {"kv": kv}
    h2 = apply_norm(x, p["ln2"], cfg.norm)
    x = x + apply_mlp(h2, p["mlp"], cfg.mlp)
    return x, new_cache


def mamba_block(x: torch.Tensor, p: dict, cfg: ArchConfig, *, cache=None):
    """Returns (x, new_cache) -- new_cache {"h", "conv"} when decoding."""
    h = apply_norm(x, p["norm_m"], cfg.norm)
    y, new_cache = ssm_mod.mamba_mixer(
        h, p["mamba"], expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
        n_state=cfg.ssm_state, chunk=cfg.ssm_chunk, cache=cache)
    return x + y, new_cache


# ---------------------------------------------------------------------------
# full forward passes
# ---------------------------------------------------------------------------
def learned_positions(table: torch.Tensor, start: int,
                      size: int) -> torch.Tensor:
    """Rows [start, start + size) of the position table, with the start
    clamped into [0, rows - size] as the reference's
    `jax.lax.dynamic_slice_in_dim` clamps it: past the table, the last
    ``size`` rows."""
    rows = table.shape[0]
    if size > rows:
        raise ValueError(f"{size} positions asked of a table of {rows}")
    start = min(max(start, 0), rows - size)
    return table[start:start + size]


def decoder_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                    pos_offset: int = 0) -> torch.Tensor:
    """Prefill forward over [b, S] tokens. Returns hidden [b, S, d]."""
    check_supported(cfg)
    x = embed(tokens, params["embed"])
    S = x.shape[1]
    positions = (torch.arange(S, device=x.device) + pos_offset)[None, :]
    if cfg.pos == "learned":
        x = x + learned_positions(params["pos_embed"], pos_offset, S).to(
            x.dtype)[None]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        if cfg.family == "ssm":
            x, _ = mamba_block(x, lp, cfg)
        else:
            x, _ = dense_block(x, lp, cfg, positions)
    return apply_norm(x, params["final_norm"], cfg.norm)


def logits_from_hidden(params: dict, x: torch.Tensor, cfg: ArchConfig):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, table)


__all__ = [
    "check_supported",
    "param_shapes",
    "block_param_shapes",
    "attn_param_shapes",
    "layer_params",
    "self_attention",
    "dense_block",
    "mamba_block",
    "learned_positions",
    "decoder_forward",
    "logits_from_hidden",
]
