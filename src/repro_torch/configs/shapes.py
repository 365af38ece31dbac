"""The assigned input-shape sets and their storage-free stand-ins.

Port of `repro/configs/shapes.py`. Four shapes per LM architecture (40
cells):
  train_4k     seq_len=4096,   global_batch=256   (train_step)
  prefill_32k  seq_len=32768,  global_batch=32    (inference prefill)
  decode_32k   seq_len=32768,  global_batch=128   (serve_step: 1 new token,
                                                   KV cache of seq_len)
  long_500k    seq_len=524288, global_batch=1     (long-context decode;
                                                   sub-quadratic archs only)

`input_specs(cfg, shape)` returns (kind, specs): kind selects the step
(`make_train_step`, `make_prefill` or `make_decode_step`), and specs are
meta tensors (shape and dtype, no storage), the tree the reference builds
from ShapeDtypeStructs: bf16 frames and patches, int32 tokens, the cache
of `abstract_cache` (its SSM state float32).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import CDT
from repro_torch.models.model import abstract_cache


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason). long_500k only for sub-quadratic archs."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500K-token decode is skipped per assignment"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _i32(shape) -> torch.Tensor:
    return _meta(shape, torch.int32)


def sequence_batch(cfg: ArchConfig, B: int, S: int) -> dict:
    """The batch of a train or prefill step as meta tensors: the
    encoder-decoder splits S between source frames and target tokens; a
    frontend puts its embeddings before the text."""
    if cfg.enc_dec:
        return {"src": _meta((B, S // 2, cfg.d_model), CDT),
                "tokens": _i32((B, S // 2))}
    if cfg.frontend:
        nf = cfg.n_frontend_tokens
        return {"frontend": _meta((B, nf, cfg.d_model), CDT),
                "tokens": _i32((B, S - nf))}
    return {"tokens": _i32((B, S))}


def input_specs(cfg: ArchConfig, shape_name: str) -> tuple[str, dict]:
    """Storage-free stand-ins for every model input of this cell."""
    sp = SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len
    if sp.kind in ("train", "prefill"):
        return sp.kind, {"batch": sequence_batch(cfg, B, S)}
    # decode: one new token against a cache of S
    src_len = (S // 2) if cfg.enc_dec else 0
    return "decode", {
        "cache": abstract_cache(cfg, B, S, src_len=src_len),
        "tokens": _i32((B, 1)),
        "cache_len": _i32(()),
    }


__all__ = ["SHAPES", "ShapeSpec", "shape_applicable", "input_specs"]
