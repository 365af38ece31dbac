"""LM assembly for every family of the configs.

Port of `repro/models/transformer.py`. Families:
  dense   -- attn + MLP                    (granite, chatglm3, tinyllama,
                                            qwen2; phi-3-vision's backbone)
  moe     -- attn + MoE (+ dense residual) (dbrx, arctic)
  ssm     -- mamba2 mixer only             (mamba2)
  hybrid  -- parallel attn + mamba heads   (hymba)
  audio   -- encoder/decoder + cross-attn  (seamless; frontend stubbed)
A vision frontend (phi-3-vision) is precomputed patch embeddings put
before the text.

Parameters are stacked with a leading [n_layers] axis, as in the
reference; the forward passes walk the layers with a Python loop. While
autograd records them (training), each block runs under the config's
activation checkpointing (`cfg.remat`, as the reference's `_maybe_remat`);
prefill and decode run the blocks directly. Every
prefill attention -- causal self-attention, with a sliding window where
the config has one, the encoder's non-causal self-attention and the
decoder's cross-attention -- goes through the flash-attention kernel, and
every SSM prefill scan through the SSD-scan kernel. Decode attends to the
KV cache, which `self_attention` updates in place; its cross-attention
(one query over the encoder's frames) runs the flash-attention kernel too,
as in the reference.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    embed,
    mlp_param_shapes,
    rms_norm,
    unembed,
)


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


def _mamba_shapes(cfg: ArchConfig) -> dict:
    return ssm_mod.mamba_param_shapes(
        cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
        n_state=cfg.ssm_state, conv_width=cfg.conv_width)


def block_param_shapes(cfg: ArchConfig, cross: bool = False) -> dict:
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"norm_m": _norm_shapes(d, cfg.norm),
                "mamba": _mamba_shapes(cfg)}
    shapes: dict = {"ln1": _norm_shapes(d, cfg.norm),
                    "attn": attn_param_shapes(cfg)}
    if cfg.hybrid:
        shapes["mamba"] = _mamba_shapes(cfg)
        shapes["branch_norm_a"] = _norm_shapes(
            cfg.n_heads * cfg.resolved_head_dim, "rms")
        shapes["branch_norm_m"] = _norm_shapes(d, "rms")
    if cross:
        shapes["ln_x"] = _norm_shapes(d, cfg.norm)
        shapes["xattn"] = attn_param_shapes(cfg)
    shapes["ln2"] = _norm_shapes(d, cfg.norm)
    if cfg.family == "moe":
        shapes["moe"] = moe_mod.moe_param_shapes(d, cfg.moe_dff,
                                                 cfg.n_experts)
        if cfg.dense_residual:
            shapes["mlp"] = mlp_param_shapes(d, cfg.d_ff, cfg.mlp)
    else:
        shapes["mlp"] = mlp_param_shapes(d, cfg.d_ff, cfg.mlp)
    return shapes


def param_shapes(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    shapes: dict = {"embed": (cfg.vocab, d)}
    if cfg.pos == "learned":
        shapes["pos_embed"] = (cfg.max_seq, d)
    shapes["layers"] = {k: _stack(v, cfg.n_layers) for k, v in
                        block_param_shapes(cfg, cross=cfg.enc_dec).items()}
    if cfg.enc_dec:
        shapes["enc_layers"] = {k: _stack(v, cfg.n_enc_layers) for k, v in
                                block_param_shapes(cfg).items()}
        shapes["enc_final_norm"] = _norm_shapes(d, cfg.norm)
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
def _project(x: torch.Tensor, p: dict, name: str, heads: int,
             cfg: ArchConfig) -> torch.Tensor:
    """x @ w{name} (+ b{name}) as [b, s, heads, hd]."""
    b, s, _ = x.shape
    y = torch.matmul(x, p["w" + name].to(x.dtype))
    if cfg.qkv_bias:
        y = y + p["b" + name].to(x.dtype)
    return y.reshape(b, s, heads, cfg.resolved_head_dim)


def _project_qkv(x: torch.Tensor, p: dict, cfg: ArchConfig):
    return (_project(x, p, "q", cfg.n_heads, cfg),
            _project(x, p, "k", cfg.n_kv_heads, cfg),
            _project(x, p, "v", cfg.n_kv_heads, cfg))


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


def _wo(o: torch.Tensor, p: dict) -> torch.Tensor:
    return torch.matmul(o, p["wo"].to(o.dtype))


def dense_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                positions: torch.Tensor, *, cache=None, cache_len=None,
                enc_out=None):
    """Every family but ssm. Returns (x, new_cache, aux): new_cache holds
    "kv" (and the hybrid's "mamba") when decoding; ``enc_out`` is this
    layer's precomputed cross-attention (K, V); aux is the MoE's
    load-balancing loss (0.0 for the other families)."""
    h = apply_norm(x, p["ln1"], cfg.norm)
    ao, kv = self_attention(h, p["attn"], cfg, positions,
                            cache=None if cache is None else cache["kv"],
                            cache_len=cache_len)
    new_cache = {} if cache is None else {"kv": kv}
    if cfg.hybrid:
        # Hymba: attention and mamba run in parallel on the same input; each
        # branch output is normalized, then averaged (arXiv:2411.13676).
        mo, mcache = ssm_mod.mamba_mixer(
            h, p["mamba"], expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
            n_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
            cache=None if cache is None else cache["mamba"])
        ao = rms_norm(ao, p["branch_norm_a"]["scale"])
        mo = rms_norm(mo, p["branch_norm_m"]["scale"])
        x = x + 0.5 * (_wo(ao, p["attn"]) + mo)
        if cache is not None:
            new_cache["mamba"] = mcache
    else:
        x = x + _wo(ao, p["attn"])
    if enc_out is not None:
        hx = apply_norm(x, p["ln_x"], cfg.norm)
        q = _project(hx, p["xattn"], "q", cfg.n_heads, cfg)
        ek, ev = enc_out
        o = attn.flash_attention(q, ek, ev, causal=False, window=None)
        x = x + _wo(o.reshape(*o.shape[:2], -1), p["xattn"])
    h2 = apply_norm(x, p["ln2"], cfg.norm)
    aux = 0.0
    if cfg.family == "moe":
        b, s, d = h2.shape
        y, aux = moe_mod.moe_ffn(h2.reshape(b * s, d), p["moe"],
                                 n_experts=cfg.n_experts, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor)
        y = y.reshape(b, s, d)
        if cfg.dense_residual:
            y = y + apply_mlp(h2, p["mlp"], cfg.mlp)
    else:
        y = apply_mlp(h2, p["mlp"], cfg.mlp)
    return x + y, new_cache, aux


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


# the products whose outputs remat="dots" keeps (the reference's
# `dots_saveable`: every dot_general)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _maybe_remat(fn, params: dict, cfg: ArchConfig):
    """Port of the reference's `_maybe_remat`
    (`repro/models/transformer.py:268-278`): ``fn`` (one block) under
    activation checkpointing while autograd records the forward -- grad
    mode on and a parameter requiring grad -- else ``fn`` itself.
    ``"full"`` saves only the block's inputs and recomputes the block in
    the backward (the kernels launch again there); ``"dots"`` also keeps
    the outputs of the matrix products (`_DOT_OPS`); ``"none"``
    checkpoints nothing."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, not "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not (torch.is_grad_enabled() and any(
            t.requires_grad for t in _leaves(params))):
        return fn
    kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def encoder_forward(params: dict, src_embeds: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """Seamless encoder over precomputed frame embeddings [b, S, d]
    (frontend stub): non-causal self-attention + MLP blocks."""
    x = src_embeds.to(layers.CDT)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:x.shape[1]].to(x.dtype)[None]

    def block(x, lp):
        h = apply_norm(x, lp["ln1"], cfg.norm)
        q, k, v = _project_qkv(h, lp["attn"], cfg)
        o = attn.flash_attention(q, k, v, causal=False, window=None)
        x = x + _wo(o.reshape(*o.shape[:2], -1), lp["attn"])
        h2 = apply_norm(x, lp["ln2"], cfg.norm)
        return x + apply_mlp(h2, lp["mlp"], cfg.mlp)

    run = _maybe_remat(block, params, cfg)
    for i in range(cfg.n_enc_layers):
        x = run(x, layer_params(params["enc_layers"], i))
    return apply_norm(x, params["enc_final_norm"], cfg.norm)


def cross_kv(params: dict, enc_x: torch.Tensor, cfg: ArchConfig):
    """Each decoder layer's cross-attention K/V of the encoder output:
    ([L, b, s, Hk, hd], [L, b, s, Hk, hd])."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        xp = layer_params(params["layers"], i)["xattn"]
        ks.append(_project(enc_x, xp, "k", cfg.n_kv_heads, cfg))
        vs.append(_project(enc_x, xp, "v", cfg.n_kv_heads, cfg))
    return torch.stack(ks), torch.stack(vs)


def decoder_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                    frontend=None, enc_kv=None, pos_offset: int = 0):
    """Prefill forward over [b, S] tokens, after ``frontend`` embeddings
    [b, F, d] if given (positions run over both), cross-attending
    ``enc_kv`` if given. Returns (hidden [b, F + S, d], aux_loss [])."""
    x = embed(tokens, params["embed"])
    if frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = (torch.arange(S, device=x.device) + pos_offset)[None, :]
    if cfg.pos == "learned":
        x = x + learned_positions(params["pos_embed"], pos_offset, S).to(
            x.dtype)[None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(x, lp, enc):
        if cfg.family == "ssm":
            return mamba_block(x, lp, cfg)[0], 0.0
        y, _, layer_aux = dense_block(x, lp, cfg, positions, enc_out=enc)
        return y, layer_aux

    run = _maybe_remat(block, params, cfg)
    for i in range(cfg.n_layers):
        enc = None if enc_kv is None else (enc_kv[0][i], enc_kv[1][i])
        x, layer_aux = run(x, layer_params(params["layers"], i), enc)
        if cfg.family == "moe":
            aux = aux + layer_aux
    return apply_norm(x, params["final_norm"], cfg.norm), aux


def logits_from_hidden(params: dict, x: torch.Tensor, cfg: ArchConfig):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, table)


__all__ = [
    "param_shapes",
    "block_param_shapes",
    "attn_param_shapes",
    "layer_params",
    "self_attention",
    "dense_block",
    "mamba_block",
    "learned_positions",
    "encoder_forward",
    "cross_kv",
    "decoder_forward",
    "logits_from_hidden",
]
