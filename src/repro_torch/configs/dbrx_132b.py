"""DBRX-base: 40L fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

Port of `repro/configs/dbrx_132b.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,          # per-expert ffn width
    vocab=100352,
    norm="rms",
    mlp="swiglu",
    pos="rope",
    rope_theta=500000.0,
    n_experts=16,
    top_k=4,
    moe_dff=10752,
    source="hf:databricks/dbrx-base; unverified",
))
