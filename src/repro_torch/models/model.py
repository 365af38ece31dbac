"""Model API: parameters, KV cache, prefill and decode.

Port of `repro/models/model.py` for the dense and ssm families. Parameters are the
reference's nested dict with stacked [n_layers, ...] leaves, as float32
tensors; `params_from_reference` carries a tree of the reference's numpy
arrays across. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import CDT, apply_norm, embed


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _map_shapes(shapes, fn, path=()):
    if isinstance(shapes, dict):
        return {k: _map_shapes(v, fn, path + (k,)) for k, v in shapes.items()}
    return fn(path, shapes)


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters with the reference's distributions: norm scales,
    the SSM's ``out_norm`` and ``D`` 1, biases and ``dt_bias`` 0, ``A_log``
    log(linspace(1, 16, H)) in every layer, every other leaf
    N(0, 1) / sqrt(fan_in), fan_in being the second-to-last axis. One
    generator on ``device``, seeded with ``seed``, draws the random leaves
    in tree order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(path, shape):
        shape = tuple(shape)
        last = path[-1]
        if last in ("scale", "out_norm", "D"):
            return torch.ones(shape, device=dev)
        if last in ("bias", "bq", "bk", "bv", "b_up", "b_down", "dt_bias"):
            return torch.zeros(shape, device=dev)
        if last == "A_log":
            rates = torch.linspace(1.0, 16.0, shape[-1], device=dev)
            return torch.log(rates).expand(shape).clone()
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        w = torch.randn(shape, generator=gen, device=dev)
        return w.div_(math.sqrt(max(fan_in, 1)))

    return _map_shapes(tf.param_shapes(cfg), make)


def params_from_reference(tree, *, device="cuda") -> dict:
    """The reference's parameter tree (nested dicts of arrays, stacked
    [n_layers, ...], float32) as the port's: the same keys, float32
    tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device=dev)
                for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=dev)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Total parameter count (embeddings + blocks + head). The dense and
    ssm families have no experts, so ``active_only`` counts the same."""
    total = 0

    def add(path, shape):
        nonlocal total
        total += int(np.prod(shape))
        return shape

    _map_shapes(tf.param_shapes(cfg), add)
    return total


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The decode cache as meta tensors (shape and dtype, no storage).
    Dense: {"kv": (K, V)}, each [L, B, Smax, Hk, hd]. SSM:
    {"mamba": {"h": [L, B, H, N, P] float32, "conv": [L, B, W-1, conv_ch]}},
    no KV. bf16 unless the config's ``kv_dtype`` says otherwise."""
    tf.check_supported(cfg)
    dtype = CDT if cfg.kv_dtype == "bfloat16" else getattr(torch,
                                                            cfg.kv_dtype)
    L = cfg.n_layers
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_headdim
        conv_ch = d_inner + 2 * cfg.ssm_state
        return {"mamba": {
            "h": torch.empty((L, batch, H, cfg.ssm_state, cfg.ssm_headdim),
                             dtype=torch.float32, device="meta"),
            "conv": torch.empty((L, batch, cfg.conv_width - 1, conv_ch),
                                dtype=dtype, device="meta")}}
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    kv = torch.empty(shape, dtype=dtype, device="meta")
    return {"kv": (kv, kv)}


def _zeros_like_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_zeros_like_tree(v, dev) for v in tree)
    return torch.zeros_like(tree, device=dev)


def zero_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict:
    """A zeroed decode cache (the tree of `abstract_cache`) on ``device``."""
    return _zeros_like_tree(abstract_cache(cfg, batch, max_seq),
                            resolve_device(device))


def _as_tokens(tokens, params: dict) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.int64,
                           device=params["embed"].device)


def make_decode_step(cfg: ArchConfig):
    """decode_step(params, cache, tokens [B, 1], cache_len) ->
    (logits [B, V], cache). One new token against the cache; the cache's
    tensors (K/V, or the SSM's h and conv) are updated in place and
    returned. Every batch row advances, as in the reference."""
    tf.check_supported(cfg)

    def decode_step(params, cache, tokens, cache_len):
        x = embed(_as_tokens(tokens, params), params["embed"])
        if cfg.family == "ssm":
            h_all, conv_all = cache["mamba"]["h"], cache["mamba"]["conv"]
            for i in range(cfg.n_layers):
                x, new = tf.mamba_block(
                    x, tf.layer_params(params["layers"], i), cfg,
                    cache={"h": h_all[i], "conv": conv_all[i]})
                h_all[i] = new["h"]
                conv_all[i] = new["conv"]
            x = apply_norm(x, params["final_norm"], cfg.norm)
            return tf.logits_from_hidden(params, x, cfg)[:, 0, :], cache
        positions = torch.full((1, 1), int(cache_len), dtype=torch.int64,
                               device=x.device)
        if cfg.pos == "learned":
            x = x + tf.learned_positions(params["pos_embed"], int(cache_len),
                                         1).to(x.dtype)[None]
        k_all, v_all = cache["kv"]
        for i in range(cfg.n_layers):
            x, _ = tf.dense_block(x, tf.layer_params(params["layers"], i),
                                  cfg, positions,
                                  cache={"kv": (k_all[i], v_all[i])},
                                  cache_len=cache_len)
        x = apply_norm(x, params["final_norm"], cfg.norm)
        logits = tf.logits_from_hidden(params, x, cfg)
        return logits[:, 0, :], cache

    return decode_step


def make_prefill(cfg: ArchConfig):
    """prefill(params, batch) -> (logits_last [B, V], hidden [B, S, d]).

    The full-context forward: every layer's attention (dense) or SSD scan
    (ssm) is one launch of its kernel on the card. It builds no cache, as in
    the reference (its serving engine steps prompts token by token)."""
    tf.check_supported(cfg)

    def prefill(params, batch):
        tokens = _as_tokens(batch["tokens"], params)
        hidden = tf.decoder_forward(params, tokens, cfg)
        logits = tf.logits_from_hidden(params, hidden[:, -1:, :], cfg)
        return logits[:, 0, :], hidden

    return prefill


__all__ = [
    "init_params",
    "params_from_reference",
    "count_params",
    "abstract_cache",
    "zero_cache",
    "make_decode_step",
    "make_prefill",
]
