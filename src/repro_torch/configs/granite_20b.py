"""IBM Granite 20B (code): GPT-BigCode style, MQA kv=1, gelu MLP, learned
positions [arXiv:2405.04324].

Port of `repro/configs/granite_20b.py` (the same data).
"""
from repro_torch.configs import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    norm="ln",
    mlp="gelu",
    qkv_bias=True,
    pos="learned",
    max_seq=32768 + 8192,
    source="arXiv:2405.04324; hf",
))
