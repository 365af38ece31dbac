"""Hymba-1.5B: parallel attention + Mamba heads per block, sliding-window
attention [arXiv:2411.13676].

Scan-over-layers keeps the stack homogeneous: all layers use SWA (the
published model keeps 3 global-attention layers; omitted here and noted in
DESIGN.md -- long_500k requires sub-quadratic attention everywhere anyway).


Port of `repro/configs/hymba_1_5b.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    norm="rms",
    mlp="swiglu",
    pos="rope",
    hybrid=True,
    window=1024,
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=1,          # SSM branch operates at d_model width
    ssm_chunk=128,
    source="arXiv:2411.13676; hf",
))
