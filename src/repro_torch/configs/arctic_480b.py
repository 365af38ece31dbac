"""Snowflake Arctic: 35L, 128-expert top-2 MoE + dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

Port of `repro/configs/arctic_480b.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,           # dense residual FFN width
    vocab=32000,
    norm="rms",
    mlp="swiglu",
    pos="rope",
    n_experts=128,
    top_k=2,
    moe_dff=4864,
    dense_residual=True,
    optimizer_dtype="bfloat16",   # 480B: fp32 m/v does not fit a single pod
    source="hf:Snowflake/snowflake-arctic-base; hf",
))
