"""Phi-3-vision 4.2B: phi3-mini text backbone + CLIP vision frontend
(stubbed as precomputed patch embeddings) [hf:microsoft/Phi-3-vision-128k].

Port of `repro/configs/phi3_vision_4_2b.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,        # MHA
    d_ff=8192,
    vocab=32064,
    norm="rms",
    mlp="swiglu",
    pos="rope",
    frontend="vision",
    n_frontend_tokens=256,     # one low-res image = 256 patch embeddings
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
))
