"""PyTorch + CUDA port of the Nezha reproduction (the `repro` package is
the reference). It imports torch and numpy, never JAX and no module of
`repro`.

Layout mirrors `repro`: `core/` (cluster API, fused DOM engine, recovery,
clock sync), `sim/` (network model, workload driver), `kernels/` (the
hand-written Hopper kernels `dom_admit` and `dom_release`, their plain
torch versions, and the ctypes build).
"""
