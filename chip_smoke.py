#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), torch/CUDA/nvcc versions;
  2. build of the CUDA kernels from the checkout's sources (seconds), with
     ptxas's registers and spills for each flash_attention instantiation,
     each kernel of the DOM sorts (dom_admit's cluster kernel among them),
     each ssd_scan kernel and the inchash kernel, and how many of
     dom_admit's 16-block clusters the card holds at once;
  3. each kernel against its plain torch version on the card, exact, on a
     realistic DOM batch (lognormal 60 us one-way delays, 2 % drops,
     deadlines at send + 120 us) at n in {1e4, 1e5, 1e6} and R = 3 and at
     the main shape (1e4 requests padded to 16384 lanes), and dom_release
     also on a 2^24-lane backlog; timed with CUDA events per call (eager,
     and replayed from a CUDA graph, which leaves out the host's work)
     beside the plain version; each row prints its route and the share of
     the byte bound, each dom_release row one stable `torch.sort` of the
     same keys; at the main shape dom_release, and at every size up to
     16384 dom_admit, also run the onesweep route on the same inputs (held
     against the plain version too, and timed);
  4. the main path: `make_cluster("nezha-vectorized")` driven by the
     `WorkloadDriver` -- 3 replicas (f = 1), 1 proxy, 10 ms epochs,
     open-loop Poisson at 1e6 req/s, 50 % reads, Zipf 0.5 over 1 M keys,
     per-key-class commutativity, 0.2 s, K = 16 epoch windows -- on the
     card with the launch counts reset just before and read just after
     (every dom_admit and dom_release call must take the small route, one
     launch a call), then the same run on the CPU (plain versions), which
     must agree bit for bit;
  5. the flash-attention kernels against their plain version on the card
     at tinyllama-1.1b's prefill shape (B 2, S = Sk = 4096, Hq 32, Hk 4,
     D 64, causal) in bf16 (tolerance 2e-2; the tensor-core route) and
     float32 (2e-5; the scalar route) -- the reference's kernel-test
     tolerances -- and at small shapes covering non-causal, window, q
     offset, ragged S and D = 128; timed with CUDA events beside the plain
     version, `scaled_dot_product_attention` (GQA, causal) and, for bf16,
     the scalar kernel on the same inputs; each timed row prints its route,
     TFLOP/s of the visible pairs, share of the bound and ratio to SDPA;
     and one call at prefill_32k's per-sequence shape (B 1, S 32768;
     kernel and SDPA only, the last 256 rows against the plain version);
  6. the LM path at tinyllama-1.1b's full width (22 layers, d 2048,
     random weights from seed 0): `make_prefill` on B = 2 prompts of 4096
     tokens with the launch counts reset just before and read just after
     (22 launches of flash_attention per call, all on the tensor-core
     route); the same prefill at B 1,
     S 2048 through the kernel and through its plain version, whose last
     logits must agree within 2^-5 of the largest logit; the
     continuous-batching `ServingEngine` (4 slots, max_seq 256) answering
     4 prompts of 32 tokens with 16 new tokens each; and a one-slot engine
     whose decode logits after admitting a prompt must agree with
     `make_prefill`'s last logits for it, within the same tolerance;
  7. the SSD-scan kernels against their plain version on the card at
     mamba2-130m's prefill shape (b 2, S 4096, H 24, P 64, N 128, chunk
     128) with x, B, C bf16 and dt float32 as the model calls it
     (tolerance 5e-2), then all float32 (2e-4) -- the reference's
     kernel-test tolerances, on y and on the final state -- and at small
     shapes (the reference's three kernel-test shapes, a ragged S 333,
     S 32 < chunk), at hymba-1.5b's heads (H 25, N 16; b 2, S 4096) and
     at b 1, S 32768 with the main head layout; each timed with CUDA
     events (eager, and replayed from a CUDA graph) beside the plain
     version on the same inputs, with its share of the bound;
  8. the LM path at mamba2-130m's full width (24 layers, d 768, H 24, P 64,
     N 128, random weights from seed 0), as phase 6 drives tinyllama:
     prefill B 2 x S 4096 with the counts reset just before and read just
     after (24 launches of ssd_scan, none of flash_attention), a B 1 x
     S 32768 prefill (wall time, peak memory), kernel vs plain scan
     through the model at B 1 x S 2048, the 4-slot server, and one-slot
     decode vs prefill; the two comparisons compute in float32 (see
     `LM_KERNELS`: in bf16 this model's own rounding noise exceeds 2^-5),
     and the bf16 kernel-vs-plain figure is printed beside the bf16
     difference between two exact orders of the plain scan;
  9. the inchash kernel against its plain version on the card, bit for bit,
     on a seeded log (deadlines around 1.7e18 ns with full high bits,
     client ids below 1000, request ids below 2^40, a few negative values)
     at n in {1, 255, 256, 257, 333, 4095, 4096, 4097, 16384, 1e6, 2^24},
     each also against the 32-bit numpy mirror and its XOR accumulate;
     timed at 16384, 1e6 and 2^24 with CUDA events (eager, and replayed
     from a CUDA graph) beside the plain version and the byte bound; one
     call captured in a CUDA graph at n 1000 and 2^20 + 7, replayed after
     new logs were written into its captured inputs, against the plain
     version; then the hash path: each replica's durable log from phase 4's
     card run (deadlines in ns as the replicas round them) hashed through
     `ops.inchash` on the card with the count reset just before and read
     just after (one launch a replica), held bit for bit against the same
     hashes of the CPU run's log on the CPU, its wall split into building
     the columns and the calls; the replicas' final prefixes must agree,
     the last prefix must equal the XOR fold of the entry hashes and must
     not change when the log is permuted; the kernel against its plain
     version on that log, timed; the stream operations of one kernel call
     (must be 1) and of one `ops.inchash` call (torch.profiler); the hash
     path once under torch.profiler (device time of the kernels and the
     copies, busy share); and the host entry against its former three-copy
     form, in turns;
 10. the scenario catalog (`repro_torch.sim.scenario`): all 28 scenarios at
     their own settings through `run_scenario_with_trace`, on the card and
     on the CPU, which must agree bit for bit (every result key and raw
     summary key but ``tier``, the commit trace, the checkers' findings),
     with the DOM launch counts reset just before each run and read just
     after (each epoch with requests must launch each kernel once, on
     either route; the CPU runs none); for the ten scenarios with a paired
     invariant (all but `sharded-multi-key`) the checker must fire on the
     faulted run and every adversarial checker stay silent on `control()`,
     on the card as on the CPU; then six scenarios (`SCALE_SCENARIOS`) at
     phase 4's 1e6 req/s (10 clients x 1e5, epochs_per_dispatch 16, the
     rest the catalog's), card == CPU, printing the launches by route, the
     most lanes of any epoch and the walls.
The last lines are the kernels' JSON record (the DOM records also carry
phase 10's launches by route), the nvidia-smi line and
{"ok": true, "device": {...}}. The script imports nothing of JAX or `repro`.

``python3 chip_smoke.py --profile`` instead runs phases 1-2, then the
card half of phase 4 twice -- once to warm, once under `torch.profiler`
(device time by kernel, device busy share of the wall time) and cProfile
(where the host time goes) -- and then one prefill and a few serving ticks
of phases 6 and 8 under `torch.profiler`. Profiling slows the run; the
plain run's wall times are the ones phases 4, 6 and 8 print.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
# H100 SXM peaks by input type (NVIDIA data sheet): dense bf16 on the
# tensor cores, float32 outside them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FA_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py:42
# kernel vs plain version through the LM: bf16 keeps 8 significant bits;
# the kernel and the plain version round each layer's attention or scan
# output to bf16 from float32 sums taken in different orders, so a unit in
# the last place flips here and there and the flips travel through the
# residual layers: 2^-5 of the largest logit (four units at the top of its
# binade)
LM_REL_TOL = 2.0 ** -5
SSD_TOL = {"bfloat16": 5e-2, "float32": 2e-4}  # tests/test_kernels.py:64
SIZES = (10_000, 100_000, 1_000_000)
# inchash: the kernel-vs-plain sizes (edges of the reference's 256-entry
# block and of the kernel's 4096-entry tile, one epoch's padded lanes, a
# 16.8 s sweep at 1e6 req/s) and the timed ones
INCHASH_SIZES = (1, 255, 256, 257, 333, 4095, 4096, 4097, 16_384, 1_000_000,
                 1 << 24)
INCHASH_TIMED = (16_384, 1_000_000, 1 << 24)
INCHASH_BYTES = 24 + 8          # three int64 read, two uint32 written
# inchash under CUDA-graph replay with new inputs: below one tile, and past
# 2^20 with a ragged last tile
INCHASH_GRAPH_SIZES = (1_000, (1 << 20) + 7)
MAIN_N_PAD = 16_384             # pow2 bucket of ~1e4 requests per epoch


def ptxas_summary(log: str, names: tuple[str, ...]) -> list[str]:
    """Registers and spills of each kernel instantiation whose mangled name
    holds one of ``names``, from nvcc's -Xptxas=-v output."""
    import re

    rows, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if any(n in m.group(1) for n in names) else None
        elif entry and "spill stores" in line:
            spill = line.strip()
        elif entry and "Used" in line and "registers" in line:
            rows.append(f"{entry}: {line.split(':', 1)[1].strip()}; {spill}")
            entry = None
    return rows


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def realistic_batch(n: int, r: int = 3, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    send = np.sort(rng.uniform(0, n / 2e5, n))
    deadlines = send + 120e-6
    arrivals = send[:, None] + rng.lognormal(np.log(60e-6), 0.6, (n, r))
    arrivals[rng.random((n, r)) < 0.02] = np.inf
    return deadlines, arrivals


def padded(deadlines, arrivals, n_pad: int):
    import numpy as np

    n, r = arrivals.shape
    d = np.full(n_pad, np.inf)
    d[:n] = deadlines
    a = np.full((n_pad, r), np.inf)
    a[:n] = arrivals
    return d, a


def time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()                                    # warm (and first-use build)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(fn, reps: int = 20):
    """Device time of one call without the host's work around it: `reps`
    calls captured in one CUDA graph, timed over a replay. None (and a
    printed reason) when the call cannot be captured."""
    import torch

    # warm on the capture stream itself, so that state a kernel keeps per
    # stream (inchash's look-back area) is made outside the capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        print(f"  (graph capture failed, graph time not measured: {exc})")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_release(dev, d_np, *, compare_onesweep: bool = False) -> dict:
    """dom_release on card tensors == its plain version, exactly, in the
    engine's use (all admitted, clock at +inf) and a masked drain; timed
    per call (eager, and replayed from a CUDA graph) beside one stable
    `torch.sort` of the same keys and the byte bound."""
    import numpy as np
    import torch

    from repro_torch.kernels.dom_release import (dom_release,
                                                 dom_release_cuda,
                                                 dom_release_plain,
                                                 release_route)
    from repro_torch.kernels.timekeys import time_sort_keys

    m = len(d_np)
    d = torch.as_tensor(d_np, device=dev)
    rng = np.random.default_rng(m)
    drain = torch.as_tensor(rng.random(m) < 0.9, device=dev)
    now = float(np.quantile(d_np[np.isfinite(d_np)], 0.5))
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    inf = float("inf")
    err = 0
    for adm, clock in ((ones, inf), (drain, now)):
        o_k, c_k = dom_release(d, adm, clock)
        o_p, c_p = dom_release_plain(d, adm, clock)
        torch.cuda.synchronize()
        err = max(err, int((o_k.to(torch.int64) - o_p.to(torch.int64))
                           .abs().max()))
        if not (torch.equal(o_k, o_p) and int(c_k) == int(c_p)):
            raise RuntimeError(f"dom_release disagrees with its plain "
                               f"version at n={m}, now={clock}")
    keys = time_sort_keys(d)
    call = lambda: dom_release(d, ones, inf)          # noqa: E731
    lib = lambda: torch.sort(keys, stable=True)       # noqa: E731
    out = {
        "n": m, "route": release_route(m), "max_abs_err": err,
        "ms": time_ms(call), "graph_ms": time_graph_ms(call),
        "plain_ms": time_ms(lambda: dom_release_plain(d, ones, inf)),
        "bound_ms": (9 * m + 4 * m) / HBM_BYTES_PER_S * 1e3,
        "library_ms": time_ms(lib), "library_graph_ms": time_graph_ms(lib),
    }
    out["bound_share"] = out["bound_ms"] / out["ms"]
    if compare_onesweep:                  # the other route, same inputs
        got = dom_release_cuda(d, ones, inf, route="onesweep")
        if not torch.equal(got[0], dom_release_plain(d, ones, inf)[0]):
            raise RuntimeError(f"onesweep route disagrees at n={m}")
        forced = lambda: dom_release_cuda(d, ones, inf,  # noqa: E731
                                          route="onesweep")
        out["onesweep_ms"] = time_ms(forced)
        out["onesweep_graph_ms"] = time_graph_ms(forced)
    return out


def release_line(r: dict) -> str:
    """One printed row of phase 3's dom_release timings."""
    def f(x):
        return "-" if x is None else f"{x:.4f}"
    line = (f"dom_release n {r['n']:<8d} route {r['route']:8s} "
            f"{r['ms']:.4f} ms (graph {f(r['graph_ms'])}), stable torch.sort "
            f"{r['library_ms']:.4f} (graph {f(r['library_graph_ms'])}), "
            f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.6f} "
            f"(bytes), share of bound {r['bound_share']:.4f}")
    if "onesweep_ms" in r:
        line += (f"; onesweep route on the same inputs {r['onesweep_ms']:.4f}"
                 f" (graph {f(r['onesweep_graph_ms'])})")
    return line


def check_kernels(dev, n: int, n_pad: int | None = None) -> dict:
    """Each kernel's wrapper on card tensors (which launches the kernel) ==
    its plain version on the same tensors, exactly; times in ms. Up to
    dom_admit's SMALL_MAX its forced onesweep route runs too, on the same
    inputs."""
    import torch

    from repro_torch.kernels.dom_admit import (SMALL_MAX, admit_route,
                                               dom_admit, dom_admit_cuda,
                                               dom_admit_plain)

    d_np, a_np = realistic_batch(n)
    if n_pad is not None:
        d_np, a_np = padded(d_np, a_np, n_pad)
    m, R = a_np.shape
    d = torch.as_tensor(d_np, device=dev)
    a = torch.as_tensor(a_np, device=dev)
    adm_k = dom_admit(d, a)
    adm_p = dom_admit_plain(d, a)
    torch.cuda.synchronize()
    admit_err = int((adm_k.to(torch.int32) - adm_p.to(torch.int32))
                    .abs().max())
    if not torch.equal(adm_k, adm_p):
        raise RuntimeError(f"dom_admit disagrees with its plain version at "
                           f"n={m}: {int((adm_k != adm_p).sum())} cells")
    admit = {
        "route": admit_route(m), "max_abs_err": admit_err,
        "ms": time_ms(lambda: dom_admit(d, a)),
        "graph_ms": time_graph_ms(lambda: dom_admit(d, a)),
        "plain_ms": time_ms(lambda: dom_admit_plain(d, a)),
        "bound_ms": (8 * m + 8 * R * m + R * m) / HBM_BYTES_PER_S * 1e3,
        "library_ms": None,
    }
    admit["bound_share"] = admit["bound_ms"] / admit["ms"]
    if m <= SMALL_MAX:                    # the other route, same inputs
        forced = lambda: dom_admit_cuda(d, a,  # noqa: E731
                                        route="onesweep")
        if not torch.equal(forced(), adm_p):
            raise RuntimeError(f"dom_admit's onesweep route disagrees with "
                               f"the plain version at n={m}")
        admit["onesweep_ms"] = time_ms(forced)
        admit["onesweep_graph_ms"] = time_graph_ms(forced)
    return {
        "n": m, "R": R,
        "dom_admit": admit,
        "dom_release": check_release(dev, d_np,
                                     compare_onesweep=n_pad is not None),
    }


def admit_line(n: int, R: int, r: dict) -> str:
    """One printed row of phase 3's dom_admit timings."""
    def f(x):
        return "-" if x is None else f"{x:.4f}"
    line = (f"dom_admit   n {n:<8d} R {R} route {r['route']:8s} "
            f"{r['ms']:.4f} ms (graph {f(r['graph_ms'])}), plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.6f} (bytes), share "
            f"of bound {r['bound_share']:.5f}")
    if "onesweep_ms" in r:
        line += (f"; onesweep route on the same inputs {r['onesweep_ms']:.4f}"
                 f" (graph {f(r['onesweep_graph_ms'])})")
    return line


def attention_inputs(dev, B, S, Sk, Hq, Hk, D, dtype, seed=0):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, S, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D)))


def attention_bound_ms(B, S, Sk, Hq, Hk, D, dtype, causal, window=None,
                       q_offset=0) -> tuple[float, str]:
    """Least time on the card: FLOPs of the visible pairs at the peak for
    the inputs' type, or q, k, v read once and the output written once at
    the HBM rate, whichever is longer."""
    from repro_torch.kernels.flash_attention import attention_flops

    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * D * (2 * B * S * Hq + 2 * B * Sk * Hk)
    flops = attention_flops(B, S, Sk, Hq, D, causal=causal, window=window,
                            q_offset=q_offset)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_call(q, k, v, causal: bool):
    """One `scaled_dot_product_attention` call on the same inputs, in its
    [B, H, S, D] layout (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)


def fa_smem() -> dict:
    """Dynamic shared memory of a tensor-core attention block, by D."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    fn = build.library("flash_attention").flash_attention_tc_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return {D: fn(D) for D in HEAD_DIMS}


def check_attention(dev, B, S, Sk, Hq, Hk, D, dtype, causal=True,
                    window=None, q_offset=0, timed=False) -> dict:
    """flash_attention's kernel == its plain version within the tolerance
    of its dtype; with ``timed``, kernel, plain and SDPA times in ms."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    dt = getattr(torch, dtype)
    q, k, v = attention_inputs(dev, B, S, Sk, Hq, Hk, D, dt, seed=S + D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max().cpu())
    shape = (f"B{B} S{S} Sk{Sk} Hq{Hq} Hk{Hk} D{D} {dtype} causal={causal}"
             f" window={window} q_offset={q_offset}")
    if not (err <= FA_TOL[dtype] and torch.isfinite(got).all()):
        raise RuntimeError(f"flash_attention disagrees with its plain "
                           f"version at {shape}: max abs err {err}")
    del want
    res = {"shape": shape, "max_abs_err": err,
           "route": fa.kernel_route(dt)}
    if timed:
        bound, by = attention_bound_ms(B, S, Sk, Hq, Hk, D, dtype, causal,
                                       window, q_offset)
        lib = None
        if window is None and q_offset == 0 and S == Sk:
            lib = time_ms(sdpa_call(q, k, v, causal))
        res.update(ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw)),
                   plain_ms=time_ms(
                       lambda: fa.flash_attention_plain(q, k, v, **kw), 5),
                   bound_ms=bound, bound_by=by, library_ms=lib)
        res.update(attention_rates(res, B, S, Sk, Hq, D, causal, window,
                                   q_offset))
        if res["route"] == "tensor_core":
            # the scalar kernel on the same bf16 inputs, for comparison
            res["scalar_ms"] = time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, scalar=True, **kw))
    torch.cuda.empty_cache()
    return res


def attention_rates(res: dict, B, S, Sk, Hq, D, causal, window=None,
                    q_offset=0) -> dict:
    """TFLOP/s of the visible pairs, share of the bound and ratio to SDPA
    of a timed attention row."""
    from repro_torch.kernels.flash_attention import attention_flops

    flops = attention_flops(B, S, Sk, Hq, D, causal=causal, window=window,
                            q_offset=q_offset)
    lib = res.get("library_ms")
    return {"tflops": flops / res["ms"] / 1e9,
            "bound_share": res["bound_ms"] / res["ms"],
            "vs_library": res["ms"] / lib if lib else None}


def attention_line(r: dict) -> str:
    """One printed row of phase 5's timings."""
    line = (f"{r['route']} route, {r['ms']:.4f} ms, {r['tflops']:.1f} "
            f"TFLOP/s, bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
            f"share {r['bound_share']:.3f})")
    if r.get("library_ms") is not None:
        line += (f", sdpa {r['library_ms']:.4f} ms (kernel/sdpa "
                 f"{r['vs_library']:.3f})")
    if "plain_ms" in r:
        line += f", plain {r['plain_ms']:.4f} ms"
    if "scalar_ms" in r:
        line += f", scalar kernel on the same bf16 {r['scalar_ms']:.4f} ms"
    return line


def time_prefill_32k(dev) -> dict:
    """The kernel's and SDPA's times at prefill_32k's per-sequence shape
    (B 1, S 32768, tinyllama heads, bf16, causal; mean of 3 calls after a
    warm one), and the kernel's last 256 rows against the plain version."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    B, S, Hq, Hk, D = 1, 32768, 32, 4, 64
    q, k, v = attention_inputs(dev, B, S, S, Hq, Hk, D, torch.bfloat16)
    bound, by = attention_bound_ms(B, S, S, Hq, Hk, D, "bfloat16", True)
    out = {"shape": f"B{B} S{S} Hq{Hq} Hk{Hk} D{D} bfloat16 causal",
           "route": fa.kernel_route(q.dtype),
           "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v), 3),
           "library_ms": time_ms(sdpa_call(q, k, v, True), 3),
           "bound_ms": bound, "bound_by": by}
    out.update(attention_rates(out, B, S, S, Hq, D, True))
    got = fa.flash_attention_cuda(q[:, -256:].contiguous(), k, v,
                                  q_offset=S - 256)
    tail = fa.flash_attention_plain(q[:, -256:], k, v, q_offset=S - 256)
    out["tail_max_abs_err"] = float((got.float() - tail.float()).abs()
                                    .max().cpu())
    if out["tail_max_abs_err"] > FA_TOL["bfloat16"]:
        raise RuntimeError(f"flash_attention's last 256 rows at S 32768 "
                           f"disagree: {out['tail_max_abs_err']}")
    return out


def check_ssd(dev, b, S, H, P, N, chunk, dtype, dt_dtype=None) -> dict:
    """ssd_scan's kernels == their plain version within the reference's
    kernel-test tolerance of x's dtype (|got - want| <= tol + tol |want|,
    on y and the final state); timed (CUDA events, mean of 20 after a warm
    call; eager, and replayed from a CUDA graph) beside the plain version
    on the same inputs and the bound."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    dt_dtype = dt_dtype or dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(S + H)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(b, S, H, P).to(getattr(torch, dtype))
    dt = (randn(b, S, H).abs() * 0.3 + 0.01).to(getattr(torch, dt_dtype))
    A = -randn(H).abs() - 0.1
    B, C = (randn(b, S, N).to(getattr(torch, dtype)) for _ in range(2))
    got_y, got_h = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)
    want_y, want_h = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    shape = (f"b{b} S{S} H{H} P{P} N{N} chunk{chunk} x/B/C {dtype} "
             f"dt {dt_dtype}")
    errs = {}
    for name, got, want in (("y", got_y, want_y), ("h", got_h, want_h)):
        diff = (got.float() - want.float()).abs()
        excess = float((diff - tol * want.float().abs()).max().cpu())
        errs[name] = float(diff.max().cpu())
        if not (excess <= tol and torch.isfinite(got).all()):
            raise RuntimeError(f"ssd_scan's {name} disagrees with its plain "
                               f"version at {shape}: max abs err "
                               f"{errs[name]}, tolerance {tol} + {tol} |want|")
    del got_y, got_h, want_y, want_h
    size = {"bfloat16": 2, "float32": 4}
    t_bytes = ssd.ssd_scan_bytes(b, S, H, P, N, x_size=size[dtype],
                                 bc_size=size[dtype],
                                 dt_size=size[dt_dtype]) / HBM_BYTES_PER_S
    t_ops = ssd.ssd_scan_flops(b, S, H, P, N, chunk) / PEAK_FLOPS[dtype]
    res = {"shape": shape, "max_abs_err": errs["y"],
           "state_max_abs_err": errs["h"],
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None}
    call = lambda: ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)  # noqa: E731
    res["ms"] = time_ms(call)
    res["graph_ms"] = time_graph_ms(call)
    res["plain_ms"] = time_ms(lambda: ssd.ssd_scan_plain(x, dt, A, B, C,
                                                         chunk=chunk))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    torch.cuda.empty_cache()
    return res


def synthetic_log(n: int, seed: int = 0):
    """A replica log's (deadline_ns, client_id, request_id) columns, int64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = rng.integers(1_600_000_000_000_000_000, 1_800_000_000_000_000_000, n)
    c = rng.integers(0, 1000, n)
    r = rng.integers(0, 2 ** 40, n)
    for col in (d, c, r):
        neg = rng.random(n) < 0.01
        col[neg] = -rng.integers(1, 2 ** 62, int(neg.sum()))
    return d, c, r


def check_inchash(dev, cols, timed: bool = False) -> dict:
    """inchash's kernel == its plain version on the card and == the 32-bit
    numpy mirror and its XOR accumulate, bit for bit; with ``timed``,
    kernel (eager and CUDA-graph) and plain times in ms beside the byte
    bound."""
    import numpy as np
    import torch

    from repro_torch.core.hashing import entry_hash32_np
    from repro_torch.kernels import inchash as ih

    n = int(cols[0].shape[0])
    t = [torch.as_tensor(x, device=dev) for x in cols]
    got = ih.inchash_cuda(*t)
    want = ih.inchash_plain(*t)
    torch.cuda.synchronize()
    bits = [(a.view(torch.int32).to(torch.int64),
             b.view(torch.int32).to(torch.int64)) for a, b in zip(got, want)]
    err = max(int((a - b).abs().max()) for a, b in bits)
    if not all(torch.equal(a, b) for a, b in bits):
        raise RuntimeError(f"inchash disagrees with its plain version at "
                           f"n={n}: max abs err {err}")
    h_np = entry_hash32_np(*(np.asarray(x).astype(np.uint32) for x in cols))
    if not (np.array_equal(got[0].cpu().numpy(), h_np)
            and np.array_equal(got[1].cpu().numpy(),
                               np.bitwise_xor.accumulate(h_np))):
        raise RuntimeError(f"inchash disagrees with the numpy mirror at "
                           f"n={n}")
    res = {"n": n, "max_abs_err": err}
    if timed:
        res.update(ms=time_ms(lambda: ih.inchash_cuda(*t)),
                   graph_ms=time_graph_ms(lambda: ih.inchash_cuda(*t)),
                   plain_ms=time_ms(lambda: ih.inchash_plain(*t)),
                   bound_ms=INCHASH_BYTES * n / HBM_BYTES_PER_S * 1e3)
    return res


def check_inchash_graph(dev, n: int) -> None:
    """One inchash call captured in a CUDA graph, replayed after new logs
    were written into its captured inputs, each replay == the plain version
    on those inputs; between two replays a smaller eager call on the
    capture stream shares the graph's look-back area. Raises on a
    difference."""
    import torch

    from repro_torch.kernels import inchash as ih

    def same(got, cols):
        want = ih.inchash_plain(*cols)
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))

    t = [torch.as_tensor(x, device=dev) for x in synthetic_log(n, seed=7)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ih.inchash_cuda(*t)                   # the stream's area, made here
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = ih.inchash_cuda(*t)
    small = [torch.as_tensor(x, device=dev)
             for x in synthetic_log(max(n // 3, 1), seed=9)]
    for seed in (8, 10):
        for x, y in zip(t, synthetic_log(n, seed=seed)):
            x.copy_(torch.as_tensor(y))
        graph.replay()
        torch.cuda.synchronize()
        if not same(got, t):
            raise RuntimeError(f"inchash replayed from a CUDA graph with new "
                               f"inputs disagrees with its plain version at "
                               f"n={n} (log seed {seed})")
        with torch.cuda.stream(stream):
            eager = ih.inchash_cuda(*small)
        torch.cuda.synchronize()
        if not same(eager, small):
            raise RuntimeError(f"an eager inchash call between two graph "
                               f"replays disagrees at n={n // 3}")


def device_ops(fn, calls: int = 10):
    """Device operations (kernels, copies, memsets) per call of ``fn`` and
    their counts by name, from torch.profiler after a warm call; (None, {})
    when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA}
    if not ops:
        return None, {}
    return sum(ops.values()) / calls, ops


def log_hash_columns(cols: dict):
    """A durable log's (deadline_ns, client_id, request_id), the deadline
    in nanoseconds as the replicas take it: int(round(t * 1e9))."""
    import numpy as np

    deadline = cols["deadline"]
    if not np.isfinite(deadline).all():
        raise RuntimeError("a replica log holds a non-finite deadline")
    return np.rint(deadline * 1e9).astype(np.int64), cols["cid"], cols["rid"]


def replica_log_hashes(cluster, device: str, entry=None):
    """Each replica's durable log hashed through `ops.inchash` on
    ``device`` (or through ``entry``): ({replica: (h, prefix)} as
    np.uint32, host seconds building the columns, seconds of the hash
    calls up to a device sync)."""
    import torch

    from repro_torch.kernels import ops

    entry = entry or (lambda *cols: ops.inchash(*cols, device=device))
    t0 = time.perf_counter()
    cols = {rep: log_hash_columns(c) for rep, c in sorted(
        cluster.engine.logs.replica_log_columns().items())}
    t1 = time.perf_counter()
    hashes = {rep: entry(*c) for rep, c in cols.items()}
    if device == "cuda":
        torch.cuda.synchronize()
    return hashes, t1 - t0, time.perf_counter() - t1


def three_copy_entry(d, c, r):
    """`ops.inchash` on the card as it stood before its pinned staging
    (each column cast to int64 on the host and sent in its own pageable
    copy, h and prefix pulled back in two copies), with the same kernel:
    the other side of phase 9's host-entry A/B."""
    import numpy as np
    import torch

    from repro_torch.kernels import inchash as ih

    cols = (torch.as_tensor(np.asarray(x).astype(np.int64), device="cuda")
            for x in (d, c, r))
    h, prefix = ih.inchash_cuda(*cols)
    return h.cpu().numpy(), prefix.cpu().numpy()


def profile_hash_path(cluster) -> dict:
    """One run of the hash path under torch.profiler after a warm one: its
    wall (profiler on), the device time of the inchash kernels, of the
    copies and of anything else, the device's busy share (device time
    over the wall; one stream, so the times do not overlap), and the host
    operators with the most self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    replica_log_hashes(cluster, "cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, cols_s, _ = replica_log_hashes(cluster, "cuda")
        wall = time.perf_counter() - t0
    us = {"kernel": 0.0, "copies": 0.0, "other": 0.0}
    host = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.self_cpu_time_total / 1e3, e.key, e.count))
            continue
        kind = ("kernel" if "inchash" in e.key else
                "copies" if "memcpy" in e.key.lower() else "other")
        us[kind] += e.self_device_time_total
    return {"wall_ms": wall * 1e3, "columns_ms": cols_s * 1e3,
            **{f"{k}_ms": v / 1e3 for k, v in us.items()},
            "busy_share": sum(us.values()) / 1e3 / (wall * 1e3),
            "host_ms_by_op": {f"{key} (x{count})": ms for ms, key, count
                              in sorted(host, reverse=True)[:6]}}


# The LM paths of phases 6 and 8: each runs every prefill layer through one
# kernel, whose module is swapped to its plain version for the comparison,
# and the compute type of the whole-model comparisons (kernel vs plain,
# one-slot decode vs prefill). tinyllama: the shipping bf16. mamba2-130m:
# float32. In bf16 two exact float32 orders of its plain scan (chunk 64 and
# 128) already move its last logits by more than 2^-5 of the largest logit:
# once two runs differ at all their bf16 roundings part, and 24 random
# layers carry the model's full bf16 noise, so a bf16 gate at 2^-5 cannot
# tell a right scan from a wrong one. Phase 8 prints the bf16 kernel-vs-plain
# figure beside that yardstick.
LM_KERNELS = {"tinyllama-1.1b": ("flash_attention", "bfloat16"),
              "mamba2-130m": ("ssd_scan", "float32")}


@contextlib.contextmanager
def compute_dtype(name: str):
    """The port's compute type (`CDT`) set to ``name`` inside the block."""
    import torch

    import repro_torch.models.layers as layers
    import repro_torch.models.model as model

    saved = layers.CDT
    layers.CDT = model.CDT = getattr(torch, name)
    try:
        yield
    finally:
        layers.CDT = model.CDT = saved


def drive_lm_path(dev, arch: str, long_prompt: int = 0) -> dict:
    """Phases 6 and 8: one LM at full width on the card. With
    ``long_prompt``, also one B 1 prefill of that many tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import dom_admit as admit_mod
    from repro_torch.kernels import dom_release as release_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import inchash as inchash_mod
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.model import (count_params, init_params,
                                          make_prefill)
    from repro_torch.serving.engine import GenRequest, ServingEngine

    mods = {"flash_attention": fa, "ssd_scan": ssd, "dom_admit": admit_mod,
            "dom_release": release_mod, "inchash": inchash_mod}
    kernel, cmp_dtype = LM_KERNELS[arch]
    mod = mods[kernel]
    cfg = get_config(arch)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out = {"params": count_params(cfg),
           "init_s": time.perf_counter() - t0}
    prefill = make_prefill(cfg)

    # the main path: B 2 x S 4096 prefill, counts reset just before
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 4096)),
                             device=dev)
    prefill(params, {"tokens": tokens})              # warm: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    fa.launches_tensor_core = fa.launches_scalar = 0
    t0 = time.perf_counter()
    logits, hidden = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["launches"] = {name: m.launches for name, m in mods.items()}
    out["attention_routes"] = {"tensor_core": fa.launches_tensor_core,
                               "scalar": fa.launches_scalar}
    if kernel == "flash_attention" and out["attention_routes"] != {
            "tensor_core": cfg.n_layers, "scalar": 0}:
        raise RuntimeError(f"the bf16 prefill did not run every layer on the "
                           f"tensor cores: {out['attention_routes']}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if out["launches"][kernel] != cfg.n_layers:
        raise RuntimeError(f"prefill launched {kernel} "
                           f"{out['launches'][kernel]} times, not once per "
                           f"layer ({cfg.n_layers})")
    others = {k: v for k, v in out["launches"].items() if k != kernel and v}
    if others:
        raise RuntimeError(f"{arch}'s prefill launched other kernels: "
                           f"{others}")
    if not (logits.shape == (2, cfg.vocab) and hidden.shape ==
            (2, 4096, cfg.d_model) and torch.isfinite(logits).all()
            and torch.isfinite(hidden).all()):
        raise RuntimeError("prefill output has the wrong shape or is not "
                           "finite")
    del logits, hidden

    if long_prompt:
        long = torch.as_tensor(rng.integers(0, cfg.vocab, (1, long_prompt)),
                               device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = mod.launches
        t0 = time.perf_counter()
        logits, hidden = prefill(params, {"tokens": long})
        torch.cuda.synchronize()
        out["long"] = {"tokens": long_prompt,
                       "prefill_s": time.perf_counter() - t0,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": mod.launches - before}
        if not (out["long"]["launches"] == cfg.n_layers
                and torch.isfinite(logits).all()
                and torch.isfinite(hidden).all()):
            raise RuntimeError(f"the S {long_prompt} prefill is not finite "
                               f"or skipped the kernel")
        del logits, hidden, long
        torch.cuda.empty_cache()

    # kernel vs plain version through the whole model (B 1, S 2048)
    short = tokens[:1, :2048]
    cuda_fn = getattr(mod, f"{kernel}_cuda")

    def last_logits(fn):
        setattr(mod, f"{kernel}_cuda", fn)
        try:
            return prefill(params, {"tokens": short})[0].float()
        finally:
            setattr(mod, f"{kernel}_cuda", cuda_fn)

    plain_fn = getattr(mod, f"{kernel}_plain")
    with compute_dtype(cmp_dtype):
        kern, plain = last_logits(cuda_fn), last_logits(plain_fn)
    scale = float(plain.abs().max().cpu())
    err = float((kern - plain).abs().max().cpu())
    out["prefill_vs_plain"] = {"compute": cmp_dtype, "max_abs_err": err,
                               "max_abs_logit": scale,
                               "tol": scale * LM_REL_TOL}
    if not err <= scale * LM_REL_TOL:
        raise RuntimeError(f"prefill through the kernel disagrees with the "
                           f"plain-{kernel} prefill ({cmp_dtype}): {err} > "
                           f"{scale * LM_REL_TOL}")
    if kernel == "ssd_scan":
        # the shipping bf16, beside two exact float32 orders of the plain
        # scan (chunk 64 against the config's chunk)
        kern, plain = last_logits(cuda_fn), last_logits(plain_fn)
        other = last_logits(lambda *a, chunk: plain_fn(*a, chunk=64))
        out["prefill_vs_plain_bf16"] = {
            "max_abs_err": float((kern - plain).abs().max().cpu()),
            "max_abs_logit": float(plain.abs().max().cpu()),
            "plain_chunk64_vs_plain": float((other - plain).abs().max()
                                            .cpu())}
    del kern, plain

    # the continuous-batching server: 4 prompts of 32 tokens, 16 new each
    prompts = [rng.integers(0, cfg.vocab, 32).tolist() for _ in range(4)]
    engine = ServingEngine(cfg, params, n_slots=4, max_seq=256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        if not engine.admit(GenRequest(seq_id=i, prompt=prompt, max_new=16)):
            raise RuntimeError(f"the engine refused prompt {i}")
    t_admit = time.perf_counter() - t0
    produced = 0
    while any(not r.done for r in engine.requests.values()):
        produced += engine.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    answers = [engine.requests[i].out for i in range(4)]
    if not all(len(a) == 16 and all(0 <= t < cfg.vocab for t in a)
               for a in answers):
        raise RuntimeError(f"the engine's answers are malformed: {answers}")
    out["serve"] = {"wall_s": wall, "admit_s": t_admit,
                    "decode_steps": 4 * 32 + produced, "tokens": produced,
                    "tokens_per_s": produced / wall,
                    "decode_tokens_per_s": produced / (wall - t_admit),
                    "answers": answers}

    # a one-slot engine's decode logits after admitting prompt 0 ==
    # make_prefill's last logits for it (one slot: no cache overwrite)
    with compute_dtype(cmp_dtype):
        one = ServingEngine(cfg, params, n_slots=1, max_seq=256)
        seen = []
        decode = one.decode

        def recording(*args):
            step_logits, cache = decode(*args)
            seen.append(step_logits)
            return step_logits, cache

        one.decode = recording
        one.admit(GenRequest(seq_id=0, prompt=prompts[0], max_new=1))
        last, _ = prefill(params, {"tokens": torch.as_tensor([prompts[0]],
                                                             device=dev)})
    scale = float(last.float().abs().max().cpu())
    err = float((seen[-1][0].float() - last[0].float()).abs().max().cpu())
    out["decode_vs_prefill"] = {"compute": cmp_dtype, "max_abs_err": err,
                                "max_abs_logit": scale,
                                "tol": scale * LM_REL_TOL}
    if not err <= scale * LM_REL_TOL:
        raise RuntimeError(f"one-slot decode logits disagree with "
                           f"make_prefill's: {err} > {scale * LM_REL_TOL}")
    return out


def drive_main_path(device: str, rate: float, duration: float):
    from repro_torch.core import VectorizedConfig, make_cluster
    from repro_torch.sim.workload import Workload, WorkloadDriver

    # client_timeout 1 s keeps 16-epoch windows retry-closed (a window runs
    # only while no attempt inside it can time out and retry)
    cfg = VectorizedConfig(f=1, n_clients=1, n_proxies=1, seed=0,
                           epoch_duration=10e-3, epochs_per_dispatch=16,
                           commutative=True, client_timeout=1.0,
                           device=device)
    cluster = make_cluster("nezha-vectorized", cfg)
    work = Workload(mode="open", rate_per_client=rate, duration=duration,
                    read_ratio=0.5, skew=0.5, n_keys=1_000_000, seed=0)
    t0 = time.perf_counter()
    summary = WorkloadDriver(work).run(cluster)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    return cluster, summary, time.perf_counter() - t0


def profile_main_path(rate: float, duration: float) -> None:
    """Where the card run's time goes: device time by kernel (torch.profiler,
    CUPTI) and host time by function (cProfile), on a warm second run."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    drive_main_path("cuda", rate, duration)         # warm: build, allocator
    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        host.enable()
        _, summary, wall = drive_main_path("cuda", rate, duration)
        host.disable()
    # the table's "Self CUDA time total" is the device busy time (operator
    # rows and their kernels' rows both carry it, so no sum is taken here)
    print(f"profiled main path: wall {wall:.3f} s (profiler on), "
          f"{summary['batches']} epochs with requests")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20))
    out = io.StringIO()
    pstats.Stats(host, stream=out).sort_stats("tottime").print_stats(20)
    print(out.getvalue())


def profile_lm_path(dev, arch: str) -> None:
    """Where an LM path's card time goes: one B 2 x S 4096 prefill and
    eight decode steps of a 4-slot engine, each under torch.profiler after
    a warm run (device time by kernel, device busy share of the wall)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, make_prefill
    from repro_torch.serving.engine import GenRequest, ServingEngine

    cfg = get_config(arch)
    rng = np.random.default_rng(0)
    params = init_params(cfg, seed=0, device=dev)
    prefill = make_prefill(cfg)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 4096)),
                             device=dev)
    engine = ServingEngine(cfg, params, n_slots=4, max_seq=256)
    for i in range(4):
        engine.admit(GenRequest(seq_id=i, max_new=64,
                                prompt=rng.integers(0, cfg.vocab, 8).tolist()))
    runs = (("prefill B2 x S4096", lambda: prefill(params, {"tokens": tokens})),
            ("2 decode ticks x 4 slots (8 decode steps)",
             lambda: [engine.tick() for _ in range(2)]))
    for label, fn in runs:
        fn()                                          # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"profiled {arch} {label}: wall {wall * 1e3:.2f} ms (profiler on), "
              f"device kernels {busy_us / 1e3:.2f} ms, busy share "
              f"{busy_us / 1e6 / wall:.3f}")
        print(events.table(sort_by="self_device_time_total", row_limit=15))
        print(events.table(sort_by="self_cpu_time_total", row_limit=12))


# Phase 10: the scenario catalog, and six scenarios -- one or more from each
# fault family -- at phase 4's 1e6 req/s (10 clients x 1e5, K = 16).
SCALE_SCENARIOS = ("leader-crash", "total-outage", "clock-skew-proxy-capped",
                   "leader-minority-partition", "ack-without-persist",
                   "sync-daemon-outage")
SCALE_RATE_PER_CLIENT = 1e5
TRACE_PARTS = ("log", "commits", "stamps", "sync", "durability",
               "replica_logs", "net_windows", "order_scope")


def first_difference(a, b, where: str = ""):
    """The path of the first bit-level difference between two nested
    results (dicts, lists, arrays, numbers), or None."""
    import numpy as np

    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        same = (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
        return None if same else where
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return where
        for k in a:
            d = first_difference(a[k], b[k], f"{where}[{k!r}]")
            if d is not None:
                return d
        return None
    if isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return where
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{where}[{i}]")
            if d is not None:
                return d
        return None
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return None
    return None if (a == b and type(a) is type(b)) else where


@contextlib.contextmanager
def dispatch_probe():
    """Record (lanes, padded lanes) of every epoch-body dispatch, that is of
    every epoch with requests, whether single or inside a K-epoch window."""
    from repro_torch.core.engine import DomEngine

    lanes = []
    make_body = DomEngine._body

    def probed(self, use_kcls, use_cap):
        body = make_body(self, use_kcls, use_cap)

        def run(*args, **kw):
            lanes.append((int(args[11]), int(args[3].shape[0])))
            return body(*args, **kw)
        return run

    DomEngine._body = probed
    try:
        yield lanes
    finally:
        DomEngine._body = make_body


def dom_counts() -> dict:
    from repro_torch.kernels import dom_admit, dom_release

    return {name: {"small": mod.launches_small,
                   "onesweep": mod.launches_onesweep}
            for name, mod in (("dom_admit", dom_admit),
                              ("dom_release", dom_release))}


def reset_dom_counts() -> None:
    from repro_torch.kernels import dom_admit, dom_release

    for mod in (dom_admit, dom_release):
        mod.launches = mod.launches_small = mod.launches_onesweep = 0


def run_scenario_traced(scenario, device: str, config=None) -> dict:
    """One scenario through `run_scenario_with_trace` with the DOM launch
    counts reset just before and read just after, and every dispatch
    probed. On the card each dispatch must launch each DOM kernel once; on
    the CPU (plain versions) none may launch."""
    import torch

    from repro_torch.sim.trace import run_scenario_with_trace

    reset_dom_counts()
    with dispatch_probe() as lanes:
        t0 = time.perf_counter()
        res, trace = run_scenario_with_trace(
            "nezha-vectorized", scenario, device=device, config=config)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dom_counts()
    want = len(lanes) if device == "cuda" else 0
    for name, by_route in counts.items():
        if sum(by_route.values()) != want:
            raise RuntimeError(
                f"{res.scenario} on {device}: {name} launched "
                f"{json.dumps(by_route)} for {len(lanes)} epochs with "
                f"requests (want {want})")
    return {"res": res, "trace": trace, "wall": wall, "counts": counts,
            "dispatches": len(lanes),
            "max_lanes": max((n for n, _ in lanes), default=0),
            "max_padded": max((p for _, p in lanes), default=0)}


def findings(trace) -> list:
    from repro_torch.sim.trace import check_adversarial, check_trace

    return [x.replace(trace.label, "<trace>")
            for x in check_trace(trace) + check_adversarial(trace)]


def card_equals_cpu(card: dict, cpu: dict) -> None:
    """Card run == CPU run, bit for bit: every result key and raw summary
    key but ``tier``, the commit trace, and the findings."""
    from repro_torch.sim.scenario import SCENARIO_RESULT_KEYS

    name = card["res"].scenario
    pairs = [(k, getattr(card["res"], k), getattr(cpu["res"], k))
             for k in SCENARIO_RESULT_KEYS if k != "tier"]
    pairs.append(("raw", {k: v for k, v in card["res"].raw.items()
                          if k != "tier"},
                  {k: v for k, v in cpu["res"].raw.items() if k != "tier"}))
    pairs += [(p, getattr(card["trace"], p), getattr(cpu["trace"], p))
              for p in TRACE_PARTS]
    pairs.append(("findings", findings(card["trace"]),
                  findings(cpu["trace"])))
    for key, a, b in pairs:
        d = first_difference(a, b, key)
        if d is not None:
            raise RuntimeError(f"{name}: the card and the CPU differ at {d}")
    if card["res"].tier != "torch-cuda" or cpu["res"].tier != "torch-cpu":
        raise RuntimeError(f"{name}: tiers {card['res'].tier}, "
                           f"{cpu['res'].tier}")


def scenario_line(card: dict, cpu: dict) -> str:
    r = card["res"]
    return (f"  {r.scenario}: {r.n_requests} requests, {r.committed} "
            f"committed, fast ratio {r.fast_commit_ratio:.4f}, median "
            f"{r.median_latency * 1e6:.1f} us, p90 {r.p90_latency * 1e6:.1f} "
            f"us, view changes {r.view_changes}, recovered "
            f"{r.recovered_entries}, faults applied {r.applied_faults} "
            f"skipped {r.skipped_faults}, findings {len(findings(card['trace']))}"
            f", {card['dispatches']} epochs with requests (most lanes "
            f"{card['max_lanes']}, bucket {card['max_padded']}), dom_admit "
            f"{json.dumps(card['counts']['dom_admit'])} dom_release "
            f"{json.dumps(card['counts']['dom_release'])}, wall card "
            f"{card['wall']:.3f} s, CPU {cpu['wall']:.3f} s")


def drive_scenarios() -> dict:
    """Phase 10: every cataloged scenario at its own settings, then the six
    of `SCALE_SCENARIOS` at 1e6 req/s, each on the card and on the CPU."""
    import dataclasses

    from repro_torch.sim import scenario as sc_mod
    from repro_torch.sim.trace import ADVERSARIAL_CHECKS, check_adversarial

    totals = {"catalog": {}, "at_1e6": {}}

    def add(where, counts):
        for name, by_route in counts.items():
            acc = totals[where].setdefault(name, {"small": 0, "onesweep": 0})
            for route, n in by_route.items():
                acc[route] += n

    print(f"scenario catalog ({len(sc_mod.available_scenarios())} "
          f"scenarios at their own settings; card == CPU, bit for bit):")
    paired = 0
    t_phase = time.perf_counter()
    for name in sc_mod.available_scenarios():
        card = run_scenario_traced(name, "cuda")
        cpu = run_scenario_traced(name, "cpu")
        card_equals_cpu(card, cpu)
        add("catalog", card["counts"])
        print(scenario_line(card, cpu))
        sc = sc_mod.get_scenario(name)
        if sc.invariant is None or sc.invariant == "cross-group":
            continue
        got = ADVERSARIAL_CHECKS[sc.invariant](card["trace"])
        ctl = run_scenario_traced(sc.control(), "cuda")
        ctl_cpu = run_scenario_traced(sc.control(), "cpu")
        card_equals_cpu(ctl, ctl_cpu)
        add("catalog", ctl["counts"])
        silent = check_adversarial(ctl["trace"])
        print(f"    paired invariant {sc.invariant!r}: {len(got)} "
              f"finding(s) on the faulted run, {len(silent)} on the "
              f"control (card == CPU)")
        if not got or silent:
            raise RuntimeError(f"{name}: the paired invariant "
                               f"{sc.invariant!r} gave {len(got)} on the "
                               f"fault and {len(silent)} on the control")
        paired += 1
    if paired != 10:
        raise RuntimeError(f"{paired} paired invariants held, not 10")
    catalog_s = time.perf_counter() - t_phase
    print(f"  catalog: {paired} paired invariants fire on the fault and "
          f"stay silent on the control; DOM launches by route "
          f"{json.dumps(totals['catalog'])}; {catalog_s:.1f} s")

    print(f"six scenarios at 1e6 req/s (10 clients x "
          f"{SCALE_RATE_PER_CLIENT:g}, epochs_per_dispatch 16):")
    walls = {}
    for name in SCALE_SCENARIOS:
        sc = sc_mod.get_scenario(name)
        sc = dataclasses.replace(sc, workload=dataclasses.replace(
            sc.workload, rate_per_client=SCALE_RATE_PER_CLIENT))
        cfg = dataclasses.replace(
            sc_mod.build_config("nezha-vectorized", sc),
            epochs_per_dispatch=16)
        card = run_scenario_traced(sc, "cuda", cfg)
        cpu = run_scenario_traced(sc, "cpu", cfg)
        card_equals_cpu(card, cpu)
        add("at_1e6", card["counts"])
        print(scenario_line(card, cpu))
        if sc.invariant is not None:
            got = ADVERSARIAL_CHECKS[sc.invariant](card["trace"])
            print(f"    paired invariant {sc.invariant!r}: {len(got)} "
                  f"finding(s): {json.dumps(got)}")
        walls[name] = {"card_s": card["wall"], "cpu_s": cpu["wall"],
                       "requests": card["res"].n_requests,
                       "max_lanes": card["max_lanes"],
                       "launches_by_route": card["counts"]}
    print(f"  at 1e6 req/s: DOM launches by route "
          f"{json.dumps(totals['at_1e6'])}")
    return {"totals": totals, "walls": walls, "catalog_s": catalog_s}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the card runs of the main paths "
                             "instead of the smoke phases 3-8")
    args = parser.parse_args()
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        return fail("src/repro_torch not found: run from a checkout of the "
                    "repository")
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no GPU")
    dev = torch.device("cuda", 0)

    # -- 1. the card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build

    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, timeout=60, check=True)
    print("nvcc: " + nvcc_v.stdout.strip().splitlines()[-1])

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        per_source = build.build_all(extra_flags=("-Xptxas=-v",))
    print(log.getvalue(), end="")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + json.dumps({k: round(v, 1) for k, v in per_source.items()}))
    for line in ptxas_summary(log.getvalue(), ("fa_tc", "flash_attention",
                                               "release_small",
                                               "admit_small",
                                               "onesweep_", "ssd_",
                                               "inchash_")):
        print(f"  ptxas {line}")
    from repro_torch.kernels import dom_admit as admit_mod

    resident = {R: admit_mod.small_route_clusters(R) for R in (3, 7)}
    print(f"  dom_admit small route: 16-block clusters resident at once "
          f"(cudaOccupancyMaxActiveClusters) for R = 3 and 7: "
          f"{json.dumps(resident)}")

    rate, duration = 1e6, 0.2
    if args.profile:
        profile_main_path(rate, duration)
        for arch in LM_KERNELS:
            profile_lm_path(dev, arch)
        return 0

    # -- 3. kernels vs plain versions ------------------------------------------
    from repro_torch.kernels import dom_release as release_mod

    rows = [check_kernels(dev, n) for n in SIZES]
    main_shape = check_kernels(dev, 10_000, n_pad=MAIN_N_PAD)
    for res in rows + [main_shape]:
        print(admit_line(res["n"], res["R"], res["dom_admit"]))
    big = np.sort(np.random.default_rng(24).uniform(0, 1 << 24, 1 << 24)
                  / 1e6)                       # a 2^24-lane backlog
    release_rows = [res["dom_release"] for res in rows] + [
        check_release(dev, big), main_shape["dom_release"]]
    for r in release_rows:
        print(release_line(r))
    del big
    torch.cuda.empty_cache()

    # -- 4. the main path ----------------------------------------------------------
    admit_mod.launches = 0
    admit_mod.launches_small = 0
    admit_mod.launches_onesweep = 0
    release_mod.launches = 0
    release_mod.launches_small = 0
    release_mod.launches_onesweep = 0
    gpu_cl, gpu_sum, gpu_s = drive_main_path("cuda", rate, duration)
    launches = {"dom_admit": admit_mod.launches,
                "dom_release": release_mod.launches}
    release_routes = {"small": release_mod.launches_small,
                      "onesweep": release_mod.launches_onesweep}
    admit_routes = {"small": admit_mod.launches_small,
                    "onesweep": admit_mod.launches_onesweep}
    epochs = gpu_sum["epochs"]
    print(f"main path on {torch.cuda.get_device_name(0)}: "
          f"{gpu_sum['n_requests']} requests, {gpu_sum['committed']} "
          f"committed, fast ratio {gpu_sum['fast_commit_ratio']:.4f}, "
          f"median {gpu_sum['median_latency'] * 1e6:.1f} us, "
          f"p90 {gpu_sum['p90_latency'] * 1e6:.1f} us, {epochs} epochs "
          f"({gpu_sum['batches']} with requests), wall {gpu_s:.2f} s, "
          f"launches {json.dumps(launches)}, dom_admit by route "
          f"{json.dumps(admit_routes)}, dom_release by route "
          f"{json.dumps(release_routes)}")
    for name, count in launches.items():
        if count <= 0:
            return fail(f"the main path never launched {name}")
    if release_routes["small"] != launches["dom_release"]:
        return fail(f"not every main-path dom_release call took the small "
                    f"route: {json.dumps(release_routes)}")
    if admit_routes["small"] != launches["dom_admit"]:
        return fail(f"not every main-path dom_admit call took the small "
                    f"route: {json.dumps(admit_routes)}")
    cpu_cl, cpu_sum, cpu_s = drive_main_path("cpu", rate, duration)
    print(f"same run on the CPU (plain versions): wall {cpu_s:.2f} s")
    for key, value in gpu_sum.items():
        if key in ("tier", "backend"):
            continue
        same = (value == cpu_sum[key]) or (
            isinstance(value, float) and np.isnan(value)
            and np.isnan(cpu_sum[key]))
        if not same:
            return fail(f"summary[{key!r}] differs: card {value!r}, "
                        f"cpu {cpu_sum[key]!r}")
    lat_g = np.concatenate(gpu_cl._latencies)
    lat_c = np.concatenate(cpu_cl._latencies)
    if lat_g.tobytes() != lat_c.tobytes():
        return fail("commit latencies differ between the card and the CPU")
    for (tg, *ug), (tc, *uc) in zip(gpu_cl._trace_commits,
                                    cpu_cl._trace_commits):
        if tg.tobytes() != tc.tobytes() or any(
                np.asarray(x).tobytes() != np.asarray(y).tobytes()
                for x, y in zip(ug, uc)):
            return fail("commit trace (times, uids, fast flags) differs")
    log_g = gpu_cl.engine.logs.log_columns()
    log_c = cpu_cl.engine.logs.log_columns()
    for col in log_g:
        if log_g[col].tobytes() != log_c[col].tobytes():
            return fail(f"replica log column {col!r} differs")
    if not (gpu_sum["committed"] > 0
            and np.isfinite(gpu_sum["median_latency"])):
        return fail("the main path committed nothing")
    print("card run == CPU run, bit for bit (summary, latencies, commit "
          "trace, replica log)")

    # -- 5. flash attention vs its plain version ---------------------------
    print("flash_attention (kernel vs plain on the card):")
    fa_main = {}
    print(f"  tensor-core blocks: dynamic shared memory "
          f"{json.dumps(fa_smem())} bytes by head dim")
    for dtype in ("bfloat16", "float32"):
        r = check_attention(dev, 2, 4096, 4096, 32, 4, 64, dtype, timed=True)
        fa_main[dtype] = r
        print(f"  {r['shape']}: err {r['max_abs_err']:.3g}, "
              f"{attention_line(r)}")
    for dtype in ("bfloat16", "float32"):
        for B, S, Sk, Hq, Hk, D, causal, window, q_offset in (
                (2, 1000, 1000, 32, 4, 64, False, None, 0),
                (1, 777, 777, 32, 4, 64, True, 256, 0),
                (2, 333, 333, 16, 2, 128, True, None, 0),
                (1, 100, 1000, 8, 1, 128, False, 64, 900),
                (1, 37, 2049, 32, 4, 64, True, None, 2012)):
            r = check_attention(dev, B, S, Sk, Hq, Hk, D, dtype, causal,
                                window, q_offset)
            print(f"  {r['shape']}: err {r['max_abs_err']:.3g} "
                  f"({r['route']} route)")
    p32k = time_prefill_32k(dev)
    print(f"  prefill_32k {p32k['shape']}: {attention_line(p32k)}, last "
          f"256 rows err {p32k['tail_max_abs_err']:.3g}")

    # -- 6. the LM path at full width ----------------------------------------
    lm = drive_lm_path(dev, "tinyllama-1.1b")
    print(f"tinyllama-1.1b ({lm['params']} parameters, init "
          f"{lm['init_s']:.2f} s): prefill B2 x S4096 {lm['prefill_s']:.4f} s "
          f"({2 * 4096 / lm['prefill_s']:.0f} tokens/s), launches "
          f"{json.dumps(lm['launches'])} (flash_attention by route "
          f"{json.dumps(lm['attention_routes'])}), peak "
          f"{lm['peak_gb']:.2f} GB")
    pv, dv, sv = lm["prefill_vs_plain"], lm["decode_vs_prefill"], lm["serve"]
    print(f"  prefill B1 x S2048, kernel vs plain attention: last logits "
          f"max abs err {pv['max_abs_err']:.4g} (largest logit "
          f"{pv['max_abs_logit']:.4g}, tolerance {pv['tol']:.4g})")
    print(f"  ServingEngine(n_slots=4, max_seq=256): 4 prompts x 32 tokens, "
          f"{sv['tokens']} new tokens in {sv['wall_s']:.3f} s "
          f"({sv['tokens_per_s']:.2f} tokens/s; {sv['decode_steps']} decode "
          f"steps, admission {sv['admit_s']:.3f} s, decode ticks "
          f"{sv['decode_tokens_per_s']:.2f} tokens/s); first answer "
          f"{sv['answers'][0]}")
    print(f"  one-slot decode after admission vs make_prefill: last logits "
          f"max abs err {dv['max_abs_err']:.4g} (tolerance {dv['tol']:.4g})")

    # -- 7. the SSD scan vs its plain version ---------------------------------
    print("ssd_scan (kernel vs plain on the card):")
    ssd_main = {"bfloat16": check_ssd(dev, 2, 4096, 24, 64, 128, 128,
                                      "bfloat16", "float32"),
                "float32": check_ssd(dev, 2, 4096, 24, 64, 128, 128,
                                     "float32")}
    ssd_rows = list(ssd_main.values())
    for dtype in ("bfloat16", "float32"):
        for b, S, H, P, N, chunk in ((2, 64, 3, 4, 8, 16),
                                     (1, 40, 2, 8, 4, 16),
                                     (2, 128, 4, 16, 16, 32),
                                     (2, 333, 24, 64, 128, 128),
                                     (1, 32, 24, 64, 128, 128)):
            ssd_rows.append(check_ssd(dev, b, S, H, P, N, chunk, dtype))
    # hymba-1.5b's heads (H 25, P 64, N 16), the hybrid family's scan
    ssd_rows.append(check_ssd(dev, 2, 4096, 25, 64, 16, 128, "bfloat16",
                              "float32"))
    ssd_32k = check_ssd(dev, 1, 32768, 24, 64, 128, 128, "bfloat16",
                        "float32")
    ssd_rows.append(ssd_32k)
    for r in ssd_rows:
        g = "-" if r["graph_ms"] is None else f"{r['graph_ms']:.4f}"
        print(f"  {r['shape']}: err y {r['max_abs_err']:.3g} h "
              f"{r['state_max_abs_err']:.3g}, {r['ms']:.4f} ms (graph {g}), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), share of bound {r['bound_share']:.4f}")

    # -- 8. the SSM path at full width ---------------------------------------
    sm = drive_lm_path(dev, "mamba2-130m", long_prompt=32768)
    print(f"mamba2-130m ({sm['params']} parameters, init "
          f"{sm['init_s']:.2f} s): prefill B2 x S4096 {sm['prefill_s']:.4f} s "
          f"({2 * 4096 / sm['prefill_s']:.0f} tokens/s), launches "
          f"{json.dumps(sm['launches'])}, peak {sm['peak_gb']:.2f} GB")
    lg = sm["long"]
    print(f"  prefill B1 x S{lg['tokens']}: {lg['prefill_s']:.4f} s "
          f"({lg['tokens'] / lg['prefill_s']:.0f} tokens/s), "
          f"{lg['launches']} launches, peak {lg['peak_gb']:.2f} GB")
    pv, dv, sv = sm["prefill_vs_plain"], sm["decode_vs_prefill"], sm["serve"]
    bv = sm["prefill_vs_plain_bf16"]
    print(f"  prefill B1 x S2048, kernel vs plain scan, float32 compute: "
          f"last logits max abs err {pv['max_abs_err']:.4g} (largest logit "
          f"{pv['max_abs_logit']:.4g}, tolerance {pv['tol']:.4g}); in bf16 "
          f"{bv['max_abs_err']:.4g} (largest {bv['max_abs_logit']:.4g}), "
          f"where the plain scan at chunk 64 vs 128 differs by "
          f"{bv['plain_chunk64_vs_plain']:.4g}")
    print(f"  ServingEngine(n_slots=4, max_seq=256): 4 prompts x 32 tokens, "
          f"{sv['tokens']} new tokens in {sv['wall_s']:.3f} s "
          f"({sv['tokens_per_s']:.2f} tokens/s; {sv['decode_steps']} decode "
          f"steps, admission {sv['admit_s']:.3f} s, decode ticks "
          f"{sv['decode_tokens_per_s']:.2f} tokens/s); first answer "
          f"{sv['answers'][0]}")
    print(f"  one-slot decode after admission vs make_prefill, float32 "
          f"compute: last logits max abs err {dv['max_abs_err']:.4g} "
          f"(tolerance {dv['tol']:.4g})")

    # -- 9. the inchash kernel and the hash path --------------------------------
    from repro_torch.kernels import inchash as inchash_mod
    from repro_torch.kernels import ops

    def ms5(x):
        return "not measured" if x is None else f"{x:.5f}"

    print("inchash (kernel vs plain on the card, bit for bit):")
    ih_rows = []
    for n in INCHASH_SIZES:
        r = check_inchash(dev, synthetic_log(n, seed=n),
                          timed=n in INCHASH_TIMED)
        ih_rows.append(r)
        line = f"  n {n}: equal to the plain version and the numpy mirror"
        if "ms" in r:
            line += (f", {r['ms']:.5f} ms (graph {ms5(r['graph_ms'])}), "
                     f"plain {r['plain_ms']:.5f} ms, bound "
                     f"{r['bound_ms']:.6f} ms (bytes)")
        print(line)
    torch.cuda.empty_cache()
    for n in INCHASH_GRAPH_SIZES:
        check_inchash_graph(dev, n)
        print(f"  n {n}: one call captured in a CUDA graph, replayed after "
              f"two new logs were written into its inputs (a smaller eager "
              f"call on the capture stream between them): equal to the "
              f"plain version")
    torch.cuda.empty_cache()
    inchash_mod.launches = 0
    card_hashes, cols_s, calls_s = replica_log_hashes(gpu_cl, "cuda")
    ih_launches = inchash_mod.launches
    cpu_hashes, _, _ = replica_log_hashes(cpu_cl, "cpu")
    n_log = {rep: len(h) for rep, (h, _) in card_hashes.items()}
    print(f"hash path: the replica logs of the phase-4 card run, entries "
          f"{json.dumps(n_log)}, {ih_launches} inchash launches, wall "
          f"{(cols_s + calls_s) * 1e3:.4f} ms (building the columns "
          f"{cols_s * 1e3:.4f} ms, the {len(card_hashes)} ops.inchash calls "
          f"{calls_s * 1e3:.4f} ms)")
    if ih_launches != len(card_hashes):
        return fail(f"the hash path launched inchash {ih_launches} times, "
                    f"not once per replica ({len(card_hashes)})")
    if card_hashes.keys() != cpu_hashes.keys():
        return fail("the card and CPU runs have different replicas")
    for rep, (h, pf) in card_hashes.items():
        ch, cpf = cpu_hashes[rep]
        if not (h.dtype == pf.dtype == np.uint32 and len(h) > 0
                and h.tobytes() == ch.tobytes()
                and pf.tobytes() == cpf.tobytes()):
            return fail(f"replica {rep}'s log hashes differ between the "
                        f"card and the CPU run")
        if pf[-1] != np.bitwise_xor.reduce(h):
            return fail(f"replica {rep}'s last prefix is not the XOR fold "
                        f"of its entry hashes")
    finals = {int(pf[-1]) for _, pf in card_hashes.values()}
    if len(finals) != 1:
        return fail(f"the replicas' final prefixes differ: {finals}")
    path_cols = log_hash_columns(
        gpu_cl.engine.logs.replica_log_columns()[0])
    perm = np.random.default_rng(1).permutation(len(path_cols[0]))
    _, pf_perm = ops.inchash(*(x[perm] for x in path_cols))
    if int(pf_perm[-1]) not in finals:
        return fail("the log's set hash changed when the log was permuted")
    ih_main = check_inchash(dev, path_cols, timed=True)
    print(f"  card hashes == the CPU run's, bit for bit; final prefix "
          f"{finals.pop():#010x} on every replica, equal to the XOR fold and "
          f"unchanged under a permutation; kernel on the log (n "
          f"{ih_main['n']}): {ih_main['ms']:.5f} ms (graph "
          f"{ms5(ih_main['graph_ms'])}), plain {ih_main['plain_ms']:.5f} ms, "
          f"bound {ih_main['bound_ms']:.6f} ms (bytes); library: none (no "
          f"single PyTorch call computes an XOR scan)")
    log_t = [torch.as_tensor(x, device=dev) for x in path_cols]
    ih_ops, ih_op_names = device_ops(lambda: inchash_mod.inchash_cuda(*log_t))
    entry_ops, entry_op_names = device_ops(lambda: ops.inchash(*path_cols))
    print(f"  stream operations per call (torch.profiler): inchash_cuda "
          f"{ih_ops} {json.dumps(ih_op_names)}; ops.inchash {entry_ops} "
          f"{json.dumps(entry_op_names)}")
    if ih_ops is not None and ih_ops != 1:
        return fail(f"an inchash call took {ih_ops} stream operations, not 1")
    prof_hash = profile_hash_path(gpu_cl)
    print(f"  hash path under torch.profiler: wall "
          f"{prof_hash['wall_ms']:.4f} ms (profiler on; columns "
          f"{prof_hash['columns_ms']:.4f} ms), device: inchash kernels "
          f"{prof_hash['kernel_ms']:.4f} ms, copies "
          f"{prof_hash['copies_ms']:.4f} ms, other "
          f"{prof_hash['other_ms']:.4f} ms; busy share "
          f"{prof_hash['busy_share']:.4f}; host ms by op (self) "
          f"{json.dumps(prof_hash['host_ms_by_op'])}")
    entry_ab = {"pinned": [], "three_copies": []}
    for variant in ("pinned", "three_copies", "three_copies", "pinned") * 3:
        entry = None if variant == "pinned" else three_copy_entry
        got, _, s_calls = replica_log_hashes(gpu_cl, "cuda", entry)
        if any(got[rep][1].tobytes() != card_hashes[rep][1].tobytes()
               for rep in got):
            return fail(f"the {variant} host entry's hashes differ")
        entry_ab[variant].append(s_calls * 1e3)
    print(f"  host entry A/B, the 3 calls' ms in turns: pinned staging "
          f"{json.dumps([round(x, 4) for x in entry_ab['pinned']])}, three "
          f"pageable copies {json.dumps([round(x, 4) for x in entry_ab['three_copies']])}")

    # -- 10. the scenario catalog on the card ---------------------------------
    scen = drive_scenarios()

    record = {"kernels": []}
    for name, src, replaces in (
            ("dom_admit", "src/repro_torch/kernels/csrc/dom_admit.cu",
             "src/repro/kernels/dom_admit.py:149"),
            ("dom_release", "src/repro_torch/kernels/csrc/dom_release.cu",
             "src/repro/kernels/dom_release.py:59")):
        r = main_shape[name]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "graph_ms": r["graph_ms"], "n": main_shape["n"]}
        if name == "dom_admit":
            entry["R"] = main_shape["R"]
            entry["kernel_route"] = r["route"]
            entry["launches_by_route"] = admit_routes
            entry["onesweep_ms"] = r["onesweep_ms"]
            entry["onesweep_graph_ms"] = r["onesweep_graph_ms"]
            entry["clusters_resident"] = resident
            keys = ("route", "ms", "graph_ms", "plain_ms", "bound_ms",
                    "onesweep_ms", "onesweep_graph_ms")
            entry["sizes"] = [{"n": res["n"], "R": res["R"],
                               **{k: res[name].get(k) for k in keys}}
                              for res in rows]
        else:
            entry["kernel_route"] = r["route"]
            entry["launches_by_route"] = release_routes
            entry["onesweep_ms"] = r["onesweep_ms"]
            entry["sizes"] = [{k: x[k] for k in (
                "n", "route", "ms", "graph_ms", "plain_ms", "bound_ms",
                "library_ms", "library_graph_ms")} for x in release_rows]
        entry["scenario_launches_by_route"] = {
            where: by_kernel[name]
            for where, by_kernel in scen["totals"].items()}
        record["kernels"].append(entry)
    r = fa_main["bfloat16"]
    record["kernels"].append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": lm["launches"]["flash_attention"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"], "kernel_route": r["route"],
        "launches_by_route": lm["attention_routes"],
        "tflops": r["tflops"], "scalar_bf16_ms": r["scalar_ms"],
        "float32": {k: fa_main["float32"][k] for k in (
            "route", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "library_ms")},
        "prefill_32k": {k: p32k[k] for k in (
            "ms", "library_ms", "bound_ms", "tflops",
            "tail_max_abs_err")}})
    r = ssd_main["bfloat16"]
    ssd_keys = ("max_abs_err", "state_max_abs_err", "ms", "graph_ms",
                "plain_ms", "bound_ms", "bound_by")
    record["kernels"].append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:61",
        "launches": sm["launches"]["ssd_scan"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "shape": r["shape"],
        "state_max_abs_err": r["state_max_abs_err"],
        "graph_ms": r["graph_ms"],
        "float32": {k: ssd_main["float32"][k] for k in ssd_keys},
        "prefill_32k": {k: ssd_32k[k] for k in ssd_keys}})
    record["kernels"].append({
        "name": "inchash", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/inchash.cu",
        "replaces": "src/repro/kernels/inchash.py:59",
        "launches": ih_launches,
        "max_abs_err": max(r["max_abs_err"] for r in ih_rows + [ih_main]),
        "ms": ih_main["ms"], "plain_ms": ih_main["plain_ms"],
        "bound_ms": ih_main["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "n": ih_main["n"],
        "graph_ms": ih_main["graph_ms"], "stream_ops": ih_ops,
        "sizes": [{k: r[k] for k in ("n", "ms", "graph_ms", "plain_ms",
                                     "bound_ms")}
                  for r in ih_rows if "ms" in r],
        "hash_path": {"columns_ms": cols_s * 1e3, "calls_ms": calls_s * 1e3,
                      "entry_stream_ops": entry_ops,
                      "profiled": prof_hash, "entry_ab_ms": entry_ab}})
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
