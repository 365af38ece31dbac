"""PyTorch + CUDA port of the Nezha reproduction (the `repro` package is
the reference). It imports torch and numpy, never JAX and no module of
`repro`.

Layout mirrors `repro`: `core/` (cluster API, fused DOM engine, recovery,
clock sync), `sim/` (network model, workload driver), `configs/`,
`models/` and `serving/` (the LM substrate, dense family: prefill, decode,
the continuous-batching engine), `kernels/` (the hand-written Hopper
kernels `dom_admit`, `dom_release` and `flash_attention`, their plain
torch versions, and the ctypes build).
"""
