"""Mamba2-130M: attention-free SSD (state-space duality) [arXiv:2405.21060].

Port of `repro/configs/mamba2_130m.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,            # attention-free
    n_kv_heads=0,
    d_ff=0,               # no separate MLP; the mamba block is the mixer
    vocab=50280,
    norm="rms",
    pos="none",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    conv_width=4,
    ssm_chunk=128,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
