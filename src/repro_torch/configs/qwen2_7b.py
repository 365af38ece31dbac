"""Qwen2-7B: GQA kv=4, QKV bias, SwiGLU [arXiv:2407.10671].

Port of `repro/configs/qwen2_7b.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    norm="rms",
    mlp="swiglu",
    qkv_bias=True,
    pos="rope",
    rope_theta=1000000.0,
    source="arXiv:2407.10671; hf",
))
