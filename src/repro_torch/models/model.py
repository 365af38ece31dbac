"""Model API: parameters, the training loss, KV cache, prefill and decode.

Port of `repro/models/model.py`. Parameters are the reference's nested
dict with stacked [n_layers, ...] leaves, as float32 tensors;
`params_from_reference` carries a tree of the reference's numpy arrays
across, `train_state_from_reference` a whole training state. Entry points
run on the card unless the caller passes ``device="cpu"``.
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


def abstract_params(cfg: ArchConfig, dtype=torch.float32) -> dict:
    """The parameter tree as meta tensors (shape and dtype, no storage)."""
    return _map_shapes(tf.param_shapes(cfg), lambda p, s: torch.empty(
        tuple(s), dtype=dtype, device="meta"))


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


def _tensor_from_reference(arr, dev) -> torch.Tensor:
    """A reference array as a tensor on ``dev``: bf16 (numpy's
    ml_dtypes bfloat16, the reference's bf16 optimizer moments) stays
    bf16, anything else becomes float32."""
    if str(getattr(arr, "dtype", "")) == "bfloat16":
        f32 = np.array(arr, dtype=np.float32)
        return torch.as_tensor(f32, device=dev).to(torch.bfloat16)
    return torch.as_tensor(np.array(arr, dtype=np.float32), device=dev)


def train_state_from_reference(state, *, device="cuda"):
    """The reference's `TrainState` (its leaves as numpy arrays: params,
    ``opt.m``, ``opt.v``, ``opt.step``) as the port's: params float32,
    the moments in their own type (float32, or bf16 for a bf16
    optimizer), the step an int32 scalar, on ``device``."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor_from_reference(tree, dev)

    step = torch.as_tensor(np.array(state.opt.step, dtype=np.int32),
                           device=dev)
    return TrainState(params=params_from_reference(state.params, device=dev),
                      opt=AdamWState(step=step, m=conv(state.opt.m),
                                     v=conv(state.opt.v)))


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Total parameter count (embeddings + blocks + head); with
    ``active_only``, the expert weights count top_k / n_experts of
    themselves (each rounded down, as in the reference)."""
    total = 0
    expert_scale = (cfg.top_k / cfg.n_experts) if (
        active_only and cfg.n_experts) else 1.0

    def add(path, shape):
        nonlocal total
        n = int(np.prod(shape))
        if "moe" in path and path[-1] in ("w_gate", "w_up", "w_down"):
            n = int(n * expert_scale)
        total += n
        return shape

    _map_shapes(tf.param_shapes(cfg), add)
    return total


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def make_loss_fn(cfg: ArchConfig):
    """Returns loss_fn(params, batch) -> (loss, metrics).

    batch: {"tokens": [B, S]} (+ "frontend" [B, F, d] for the vision
    model, + "src" [B, Ssrc, d] for the encoder-decoder), moved to the
    parameters' device. The loss is the mean next-token NLL over the text
    positions after any frontend (log-softmax in float32) plus 0.01 times
    the MoE load-balancing loss; metrics: "loss", "aux_loss" and
    "ntokens" (the number of predicted tokens, a Python int)."""

    def loss_fn(params, batch):
        tokens = _on(batch["tokens"], params, torch.int64)
        if cfg.enc_dec:
            enc_x = tf.encoder_forward(params, _on(batch["src"], params),
                                       cfg)
            ekv = tf.cross_kv(params, enc_x, cfg)
            hidden, aux = tf.decoder_forward(params, tokens, cfg,
                                             enc_kv=ekv)
            n_front = 0
        else:
            frontend = batch.get("frontend")
            if frontend is not None:
                frontend = _on(frontend, params)
            hidden, aux = tf.decoder_forward(params, tokens, cfg,
                                             frontend=frontend)
            n_front = 0 if frontend is None else frontend.shape[1]
        logits = tf.logits_from_hidden(params, hidden, cfg)
        # next-token prediction on the text positions only
        pred = logits[:, n_front:-1]
        tgt = tokens[:, 1:]
        logp = torch.log_softmax(pred.float(), dim=-1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        loss = nll.mean() + 0.01 * aux
        return loss, {"loss": loss, "aux_loss": aux, "ntokens": tgt.numel()}

    return loss_fn


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   src_len: int = 0) -> dict:
    """The decode cache as meta tensors (shape and dtype, no storage):
    - "kv": (K, V), each [L, B, max_seq, Hk, hd], every family but ssm
      (the full ``max_seq``, window or not: the window masks the reads);
    - "mamba": {"h": [L, B, H, N, P] float32, "conv": [L, B, W-1,
      conv_ch]}, the ssm and hybrid families;
    - "cross": (K, V), each [L, B, src_len or n_frontend_tokens, Hk, hd],
      the encoder-decoder.
    bf16 (the compute type) unless the config's ``kv_dtype`` says
    otherwise."""
    dtype = CDT if cfg.kv_dtype == "bfloat16" else getattr(torch,
                                                            cfg.kv_dtype)
    L = cfg.n_layers

    def meta(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    cache: dict = {}
    if cfg.family != "ssm":
        kv = meta(L, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["kv"] = (kv, kv)
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_headdim
        conv_ch = d_inner + 2 * cfg.ssm_state
        cache["mamba"] = {
            "h": meta(L, batch, H, cfg.ssm_state, cfg.ssm_headdim,
                      dt=torch.float32),
            "conv": meta(L, batch, cfg.conv_width - 1, conv_ch)}
    if cfg.enc_dec:
        xkv = meta(L, batch, src_len or cfg.n_frontend_tokens,
                   cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["cross"] = (xkv, xkv)
    return cache


def _zeros_like_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_zeros_like_tree(v, dev) for v in tree)
    return torch.zeros_like(tree, device=dev)


def zero_cache(cfg: ArchConfig, batch: int, max_seq: int, src_len: int = 0,
               *, device="cuda") -> dict:
    """A zeroed decode cache (the tree of `abstract_cache`) on ``device``."""
    return _zeros_like_tree(abstract_cache(cfg, batch, max_seq, src_len),
                            resolve_device(device))


def _on(x, params: dict, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=params["embed"].device)


def make_decode_step(cfg: ArchConfig):
    """decode_step(params, cache, tokens [B, 1], cache_len) ->
    (logits [B, V], cache). One new token against the cache; the cache's
    tensors (K/V, the SSM's h and conv) are updated in place and
    returned, the cross-attention K/V read. Every batch row advances, as in
    the reference."""

    def decode_step(params, cache, tokens, cache_len):
        x = embed(_on(tokens, params, torch.int64), params["embed"])
        positions = torch.full((1, 1), int(cache_len), dtype=torch.int64,
                               device=x.device)
        if cfg.pos == "learned":
            x = x + tf.learned_positions(params["pos_embed"], int(cache_len),
                                         1).to(x.dtype)[None]
        if "mamba" in cache:
            h_all, conv_all = cache["mamba"]["h"], cache["mamba"]["conv"]
        for i in range(cfg.n_layers):
            lp = tf.layer_params(params["layers"], i)
            mamba = None if "mamba" not in cache else {
                "h": h_all[i], "conv": conv_all[i]}
            if cfg.family == "ssm":
                x, new_mamba = tf.mamba_block(x, lp, cfg, cache=mamba)
            else:
                c = {"kv": (cache["kv"][0][i], cache["kv"][1][i])}
                if mamba is not None:
                    c["mamba"] = mamba
                enc = None if "cross" not in cache else (
                    cache["cross"][0][i], cache["cross"][1][i])
                x, new, _ = tf.dense_block(x, lp, cfg, positions, cache=c,
                                           cache_len=cache_len, enc_out=enc)
                new_mamba = new.get("mamba")
            if mamba is not None:
                h_all[i] = new_mamba["h"]
                conv_all[i] = new_mamba["conv"]
        x = apply_norm(x, params["final_norm"], cfg.norm)
        logits = tf.logits_from_hidden(params, x, cfg)
        return logits[:, 0, :], cache

    return decode_step


def make_prefill(cfg: ArchConfig):
    """prefill(params, batch) -> (logits_last [B, V], hidden).

    batch: {"tokens": [B, S]}, + "src" [B, Ssrc, d] (the encoder's frame
    embeddings) for the encoder-decoder, + optionally "frontend" [B, F, d]
    (patch embeddings put before the text) otherwise. The full-context
    forward: every layer's attention and SSD scan is one launch of its
    kernel on the card (the encoder-decoder: each encoder layer's
    self-attention and each decoder layer's self- and cross-attention).
    It builds no cache, as in the reference (its serving engine steps
    prompts token by token)."""

    def prefill(params, batch):
        tokens = _on(batch["tokens"], params, torch.int64)
        if cfg.enc_dec:
            enc_x = tf.encoder_forward(params, _on(batch["src"], params),
                                       cfg)
            ekv = tf.cross_kv(params, enc_x, cfg)
            hidden, _ = tf.decoder_forward(params, tokens, cfg, enc_kv=ekv)
        else:
            frontend = batch.get("frontend")
            if frontend is not None:
                frontend = _on(frontend, params)
            hidden, _ = tf.decoder_forward(params, tokens, cfg,
                                           frontend=frontend)
        logits = tf.logits_from_hidden(params, hidden[:, -1:, :], cfg)
        return logits[:, 0, :], hidden

    return prefill


__all__ = [
    "abstract_params",
    "init_params",
    "params_from_reference",
    "train_state_from_reference",
    "make_loss_fn",
    "count_params",
    "abstract_cache",
    "zero_cache",
    "make_decode_step",
    "make_prefill",
]
