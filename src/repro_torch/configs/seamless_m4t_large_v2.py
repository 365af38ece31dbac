"""SeamlessM4T-large-v2 backbone: 24L enc + 24L dec, d=1024, MHA, audio
frontend stubbed as precomputed frame embeddings [arXiv:2308.11596].

Port of `repro/configs/seamless_m4t_large_v2.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,          # decoder layers
    n_enc_layers=24,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,        # MHA
    d_ff=8192,
    vocab=256206,
    norm="ln",
    mlp="gelu",
    qkv_bias=True,
    pos="learned",
    frontend="audio",
    n_frontend_tokens=2048,   # encoder source length (precomputed frames)
    max_seq=32768 + 8192,
    source="arXiv:2308.11596; hf",
))
