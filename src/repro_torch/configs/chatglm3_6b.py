"""ChatGLM3-6B: GQA kv=2, 2d/partial RoPE (rotary on half the head dims),
SwiGLU [arXiv:2406.12793].

Port of `repro/configs/chatglm3_6b.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    norm="rms",
    mlp="swiglu",
    qkv_bias=True,
    pos="rope2d",
    rope_frac=0.5,
    source="arXiv:2406.12793; hf",
))
