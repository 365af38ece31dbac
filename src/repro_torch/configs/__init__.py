"""Architecture configs: one module per assigned architecture.

Port of `repro/configs/__init__.py`. `get_config(name)` returns the full
published config; `smoke_config(name)` returns a reduced same-family config
for CPU smoke tests. The port's model runs the `dense` family without a
window, an encoder or a frontend (tinyllama-1.1b, qwen2-7b, ...); the other
configs are carried as data, and `repro_torch.models` refuses them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | audio | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    norm: str = "rms"                # rms | ln
    mlp: str = "swiglu"              # swiglu | gelu
    qkv_bias: bool = False
    pos: str = "rope"                # rope | rope2d | learned | none
    rope_frac: float = 1.0           # fraction of head_dim that rotates
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 128
    # hybrid (Hymba): parallel attn + SSM heads in one block
    hybrid: bool = False
    # sliding-window attention (None = full/global)
    window: Optional[int] = None
    # encoder-decoder (Seamless)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: precomputed embeddings prepended to the text
    frontend: Optional[str] = None   # audio | vision
    n_frontend_tokens: int = 0
    max_seq: int = 544 * 1024
    tie_embeddings: bool = False
    # training numerics
    optimizer_dtype: str = "float32"  # m/v dtype; bf16 for the 480B config
    remat: str = "full"               # none | full | dots -- activation ckpt
    kv_dtype: str = "bfloat16"        # KV-cache dtype (fp8 for serving opt)
    dp_only: bool = False             # fold the model axis into data (small models)
    ddp: bool = False                 # replicate params entirely (tiny models):
    #   no weight gathers at all, one gradient all-reduce per step
    serve_tp_only: bool = False       # serving: replicate weights over data
    serve_params_dtype: str = "float32"  # serving weights dtype (bf16 opt)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        return self.family == "ssm" or (self.hybrid and self.window is not None)

    def n_params(self) -> int:
        """Total parameter count (embeddings + blocks + head)."""
        from repro_torch.models.model import count_params

        return count_params(self)

    def n_active_params(self) -> int:
        from repro_torch.models.model import count_params

        return count_params(self, active_only=True)


def _reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Family-preserving reduction for CPU smoke tests."""
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab=256,
        max_seq=512,
    )
    if cfg.n_experts:
        base.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_dff=64)
    if cfg.ssm_state:
        base.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.enc_dec:
        base.update(n_enc_layers=2)
    if cfg.window is not None:
        base.update(window=64)
    if cfg.n_frontend_tokens:
        base.update(n_frontend_tokens=8)
    base.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **base)


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def smoke_config(name: str, **overrides) -> ArchConfig:
    return _reduced(get_config(name), **overrides)


def all_arch_names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        arctic_480b,
        chatglm3_6b,
        dbrx_132b,
        granite_20b,
        hymba_1_5b,
        mamba2_130m,
        phi3_vision_4_2b,
        qwen2_7b,
        seamless_m4t_large_v2,
        tinyllama_1_1b,
    )


__all__ = ["ArchConfig", "register", "get_config", "smoke_config", "all_arch_names"]
