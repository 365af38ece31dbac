"""Model API: parameters, KV cache, prefill and decode.

Port of `repro/models/model.py` for the dense family. Parameters are the
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
    """Random parameters with the reference's distributions: norm scales 1,
    biases 0, every other leaf N(0, 1) / sqrt(fan_in), fan_in being the
    second-to-last axis. One generator on ``device``, seeded with ``seed``,
    draws the leaves in tree order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(path, shape):
        shape = tuple(shape)
        last = path[-1]
        if last == "scale":
            return torch.ones(shape, device=dev)
        if last in ("bias", "bq", "bk", "bv", "b_up", "b_down"):
            return torch.zeros(shape, device=dev)
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
    """Total parameter count (embeddings + blocks + head). The dense
    family has no experts, so ``active_only`` counts the same."""
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
    """The decode cache as meta tensors (shape and dtype, no storage):
    {"kv": (K, V)}, each [L, B, Smax, Hk, hd], bf16 unless the config's
    ``kv_dtype`` says otherwise."""
    tf.check_supported(cfg)
    dtype = CDT if cfg.kv_dtype == "bfloat16" else getattr(torch,
                                                            cfg.kv_dtype)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    kv = torch.empty(shape, dtype=dtype, device="meta")
    return {"kv": (kv, kv)}


def zero_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict:
    """A zeroed decode cache {"kv": (K, V)} on ``device``."""
    dev = resolve_device(device)
    k, v = abstract_cache(cfg, batch, max_seq)["kv"]
    return {"kv": (torch.zeros_like(k, device=dev),
                   torch.zeros_like(v, device=dev))}


def _as_tokens(tokens, params: dict) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.int64,
                           device=params["embed"].device)


def make_decode_step(cfg: ArchConfig):
    """decode_step(params, cache, tokens [B, 1], cache_len) ->
    (logits [B, V], cache). One new token against the cache; the cache's
    K/V tensors are updated in place and returned."""
    tf.check_supported(cfg)

    def decode_step(params, cache, tokens, cache_len):
        x = embed(_as_tokens(tokens, params), params["embed"])
        positions = torch.full((1, 1), int(cache_len), dtype=torch.int64,
                               device=x.device)
        if cfg.pos == "learned":
            at = int(cache_len)
            x = x + params["pos_embed"][at:at + 1].to(x.dtype)[None]
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

    The full-context forward: every layer's attention is one launch of the
    flash-attention kernel on the card. It builds no cache, as in the
    reference (its serving engine steps prompts token by token)."""
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
