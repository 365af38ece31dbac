"""TinyLlama 1.1B: llama2-architecture small model [arXiv:2401.02385].

Port of `repro/configs/tinyllama_1_1b.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    norm="rms",
    mlp="swiglu",
    pos="rope",
    source="arXiv:2401.02385; hf",
))
