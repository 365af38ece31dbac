"""PyTorch + CUDA port of the Nezha reproduction (the `repro` package is
the reference). It imports torch and numpy, never JAX and no module of
`repro`.

Layout mirrors `repro`: `core/` (cluster API, the event-driven Nezha and
the eight baselines, fused DOM engine, sharded groups, recovery, clock
sync, hashes), `sim/` (event scheduler, network model and fabric,
workload driver, scenarios, trace checkers), `configs/`, `models/` and
`serving/` (the LM substrate: prefill, decode, the continuous-batching
engine, the replicated LM service), `ckpt/` (the replicated metadata
log), `launch/` (the serving driver), `kernels/` (the hand-written
Hopper kernels `dom_admit`, `dom_release`, `flash_attention`,
`ssd_scan` and `inchash`, their plain torch versions, and the ctypes
build).
"""
