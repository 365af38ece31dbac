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
     logits must agree within 2^-5 of the largest logit in bf16 (the
     float32 figure printed beside it); the
     continuous-batching `ServingEngine` (4 slots, max_seq 256) answering
     4 prompts of 32 tokens with 16 new tokens each; and a one-slot engine
     whose decode logits after admitting a prompt must agree with
     `make_prefill`'s last logits for it, within the same tolerance (both
     types again, bf16 gated);
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
     decode vs prefill; the two comparisons are gated in float32 (see
     `LM_PATHS`: in bf16 this model's own rounding noise exceeds 2^-5),
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
     most lanes of any epoch and the walls;
 11. `nezha-sharded` (`repro_torch.core.sharded`): both DOM kernels batched
     over G groups -- one launch for all G -- against their plain versions
     and against G separate launches, bit for bit, at (G, lanes) in
     {(4, 16384), (16, 4096), (64, 1024)} (small route) and (2, 65536)
     (onesweep route), each timed (eager and from a CUDA graph) beside the
     G separate launches, the plain version and the byte bound; then the
     deployment of `benchmarks/dom_scale.py`'s sharded sweep (1e6
     single-key writes over 2^20 keys in 16 epochs of 10 ms, 64 clients, 3
     replicas a group, seed 0) at G 1 (`nezha-sharded` == `nezha-vectorized`)
     and at G 4, 16 and 64 sequential and batched (`vmap_groups=True`),
     which must agree bit for bit (summary, merged latencies, every group's
     commit trace), the batched run at G 16 also on the CPU; each run with
     the DOM launch counts reset just before and read just after (batched:
     one launch of each kernel per lockstep epoch with work plus one per
     retry generation; sequential: one per body dispatch), its walls split
     into submitting, 2 warm epochs and the timed rest; and the two sharded
     scenarios on the card and the CPU, bit for bit, with no skipped fault,
     only group 1 view-changing in `sharded-group-crash` and the
     cross-group checker silent on `sharded-multi-key`'s card trace.
 12. the remaining model families (`repro_torch.models`): flash_attention
     against its plain version at the shapes their paths give it, bf16
     (2e-2) and float32 (2e-5), each timed beside its bound, the plain
     version and `scaled_dot_product_attention` (a window as its mask):
     phi-3-vision-4.2b's prefill (B 2, S 4096, 32 heads of D 96, causal;
     the D 96 route), seamless-m4t-large-v2's encoder (B 2, S = Sk 2048,
     16 heads, non-causal), its decoder's causal self-attention (B 2,
     S 4096, 16 heads), its cross attention at prefill (S 4096 over
     Sk 2048) and in a decode step (B 4, S 1 over 2048 frames),
     hymba-1.5b's windowed prefill (B 2 x 4096, 25/5 heads, window 1024),
     and dbrx-132b's and arctic-480b's prefills (B 2 x 4096, D 128, 48/8
     and 56/8 heads: groups of 6 and 7);
     then hymba-1.5b (all 32 layers), seamless-m4t-large-v2 (24 + 24
     layers over 2048 random frame embeddings), phi-3-vision-4.2b (32
     layers, 256 random patch embeddings + 3840 tokens), dbrx-132b (2 of
     40 layers) and arctic-480b (1 of 35 layers), all at full width,
     random weights from seed 0, through phase 6's `drive_lm_path`:
     prefill of B 2 x 4096 positions with every launch count reset just before and
     read just after (flash_attention once per attention, all on the
     tensor cores -- seamless 72 -- and hymba's ssd_scan once per layer),
     kernels vs plain versions through the model at B 1 x 2048 and
     one-slot decode vs prefill, each in both compute types with one gated
     (`LM_PATHS`; MoE: also the (token, layer) top-k sets that differ
     between the runs), and the 4-slot server (seamless: 24
     cross-attention launches a decode step).
 13. the event-driven backends and the replicated services
     (`repro_torch.core.protocol`, `core.baselines`,
     `serving.engine.ReplicatedLMService`): the replicated LM service (f 1:
     3 replicas on the card, one copy of the parameters, a cache each;
     n_slots 4, max_seq 128) on tinyllama-1.1b and seamless-m4t-large-v2
     at full width, random weights from seed 0, answering 4 prompts of 8
     tokens with 8 new each, then the leader's crash, 0.2 s, and the same
     questions again; the flash_attention counts reset just before the
     service is built and read after the failover (seamless: 24
     launches, on the tensor cores, for each decode step of every engine
     the replicas made; tinyllama: none); the replicas' state
     fingerprints must agree, the tokens equal a lone `ServingEngine`'s
     fed the same ADMIT/TICK sequence, bit for bit, and survive the
     failover. Then `benchmarks/figs.py`'s backend cross-check at its
     quick settings (`nezha` on the host beside `nezha-vectorized` on the
     card, f 1, 10 clients, 1000 and 5000 req/s a client, 0.2 s; both
     commit every request; the DOM counts reset before and read after the
     vectorized run: one launch of each kernel per epoch with requests),
     and Fig 9's "full" point (f 1, 3 proxies, 10 clients x 2000 req/s,
     0.25 s) on `nezha` and `nezha-nonproxy` (host code), with walls.
 14. training (`repro_torch.train`, `launch/train.py`): first each LM
     kernel's autograd Function (the forward launches the kernel, the
     backward is the plain version's) against autograd of the plain version
     at phase 5's and phase 7's shapes -- the gradients must be equal,
     exactly; then tinyllama-1.1b and mamba2-130m at full width, random from
     seed 0: 4 `make_train_step(microbatches=2)` steps each on B 8 x S 2048
     packed synthetic tokens (`repro_torch.data`, seed 0) with the
     reference's defaults (remat "full", AdamW, float32 master weights,
     bf16 compute), every launch count reset just before each step and read
     just after (flash_attention 22 x 2 microbatches x 2 -- the forward and
     its recompute -- = 88 a step, all on the tensor cores; ssd_scan 24 x 2
     x 2 = 96), step s, tokens/s, peak GB, loss and grad norm, all finite;
     one step's gradients of each model at B 1 x S 512 through the kernels
     and through their plain versions (every leaf has one, wq/wk/wv or the
     mixer's in_proj nonzero in every layer; float32 compute gated at a
     relative L2 difference of 1e-2 per leaf, bf16 compute -- tinyllama's
     tensor-core route -- at 1.5 times the plain version's own bf16 noise
     per leaf, plain bf16 against plain float32); and
     `examples/train_100m_torch.py`'s drill at its defaults (8 x 512
     transformer, 200 steps of 8 x 256, checkpoints every 50 through the
     replicated metadata log, a new Trainer restored at step 100 from the
     log's latest committed manifest, every leaf bit for bit, the loss
     falling).
 15. the rest of the data plane and the paper's applications: (a)
     flash_attention at the reference's kernel-test shapes (B 2; D 16, 32,
     16, 16 with window 64, and 64) in bf16 and float32 against its plain
     version, each timed beside SDPA and its bound, the launched route
     read from the counters (D 16 and 32 take the scalar kernel in either
     type); (b) the one-shot primitives (`repro_torch.core.vectorized`) on
     the card against the CPU, bit for bit: the watermark schedule,
     `nezha_commit_times` (key classes, replica 2 dead) and
     `classify_commits` (its own deadline order, a capped mask) at n 1e4,
     1e5 and 1e6, R 3, with the DOM counts reset just before each call and
     read just after (one `dom_admit` launch a schedule, one of each kernel
     a `nezha_commit_times`, one `dom_release` a `classify_commits`), and
     the exact oracle at n 512 against the
     watermark schedule (no launch); (c) Figs 1-3 at `benchmarks/figs.py`'s
     full settings (n_msgs 1e5), Fig 3's admission on the card (one
     onesweep `dom_admit` launch a point) equal to the CPU's; (d) the
     runtime sanitizer on phase 4's deployment, on the 28 scenarios and on
     `nezha-sharded` G 16 batched: each bit for bit its unsanitized card
     run of phases 4, 10 and 11, every epoch with requests checked, no
     violation, both walls printed; (e) the example ports:
     examples/quickstart_torch.py's `main()` once in this process on the
     card, with the flash_attention counts reset just before and read just
     after the two demos C4 opened (the training demo at smoke size, head
     dim 16, 32 launches, and the kernel demo at D 32, one: every launch
     on the scalar kernel), while replicated_serving_torch.py (on the card)
     and fair_exchange_torch.py (host only) run as subprocesses, each
     exiting 0;
 16. the sharding rules, collectives, meshes and the dry run: (a)
     `make_host_mesh()` as a one-rank NCCL `DeviceMesh`; tinyllama-1.1b's
     full-width parameters from seed 0 through `param_shardings` into
     DTensors and back, bit for bit; `elastic_step` from a recorded
     2-device world to the one card (the scaling event committed to a
     `ReplicatedMetadataLog`) and `reshard_state`, bit for bit; (b) each
     collective (`deadline_masked_mean`, `compressed_allreduce`) on NCCL
     at world size 1 equal to the same call on the CPU (gloo), bit for bit;
     (c) `repro_torch.launch.hillclimb` at batch 1 and 4 layers (its three
     cells, every iteration's terms and measured step time; the ssd_scan kernel called
     at chunk 128, 64 and 32, counted by a probe around `ssd_scan_cuda`;
     `dp_only` refuted: one card runs no collective; the qwen2-7b decode
     on a float8 KV cache); (d) `run_cell` for tinyllama-1.1b x
     {train_4k, prefill_32k, decode_32k, long_500k} and mamba2-130m x
     long_500k at one chip's batch of the 16x16 mesh, the launch counts
     reset just before each step and read just after (long_500k on
     tinyllama skipped with the reference's reason), and the roofline
     table of the results.
The last lines are the kernels' JSON record (the DOM records also carry
phase 10's launches by route, phase 11's batched rows and launches and
phase 13's cross-check launches, flash_attention and ssd_scan phase 12's
launches and attention rows, flash_attention phase 13's launches,
flash_attention and ssd_scan phase 14's launches and C1 gates, the DOM
records phase 15's one-shot and Fig 3 launches, flash_attention phase 15's
head-dim 16/32 rows, flash_attention and ssd_scan phase 16's launches by
cell and hillclimb step, ssd_scan's calls by chunk),
the nvidia-smi line and {"ok": true, "device": {...}}. The script imports
nothing of JAX or `repro`.

``python3 chip_smoke.py --profile`` instead runs phases 1-2, then the
card half of phase 4 twice -- once to warm, once under `torch.profiler`
(device time by kernel, device busy share of the wall time) and cProfile
(where the host time goes) -- and then one prefill and a few serving ticks
of phases 6, 8 and 12's configurations and one phase-14 tinyllama-1.1b
train step under `torch.profiler`. Profiling
slows the run; the plain run's wall times are the ones phases 4, 6, 8 and
12 print.
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


def sdpa_call(q, k, v, causal: bool, window=None):
    """One `scaled_dot_product_attention` call on the same inputs, in its
    [B, H, S, D] layout (the yardstick; the port never calls it). A
    window goes in as a boolean mask of the visible keys."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_mask

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal,
                                                      enable_gqa=True)
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal,
                          window=window, q_offset=0, device=q.device)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def fa_smem() -> dict:
    """Dynamic shared memory of a tensor-core attention block, by D."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import TC_HEAD_DIMS

    fn = build.library("flash_attention").flash_attention_tc_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return {D: fn(D) for D in TC_HEAD_DIMS}


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
           "route": fa.kernel_route(dt, D)}
    if timed:
        bound, by = attention_bound_ms(B, S, Sk, Hq, Hk, D, dtype, causal,
                                       window, q_offset)
        lib = None
        if q_offset == 0:          # SDPA's causal mask is ours at offset 0
            lib = time_ms(sdpa_call(q, k, v, causal, window))
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
           "route": fa.kernel_route(q.dtype, D),
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


# The LM paths at full width, random weights from seed 0: phase 6
# (tinyllama-1.1b), phase 8 (mamba2-130m) and phase 12 (the remaining
# families). Per configuration: the layers run (None: all), the kernels its
# prefill launches (each swapped to its plain version for the comparison),
# the compute type of the gated whole-model comparisons (kernel vs plain,
# one-slot decode vs prefill; the other type's figure prints beside it)
# and the length of one extra B 1 prefill (0: none).
# - bf16 where the model's own noise stays inside 2^-5: tinyllama-1.1b
#   (the shipping type), seamless-m4t-large-v2, phi-3-vision-4.2b.
# - float32 for mamba2-130m: in bf16 two exact float32 orders of its plain
#   scan (chunk 64 and 128) already move its last logits by more than 2^-5
#   of the largest logit: once two runs differ at all their bf16 roundings
#   part, and 24 random layers carry the model's full bf16 noise, so a bf16
#   gate at 2^-5 cannot tell a right scan from a wrong one. Every path
#   with ssd_scan prints that chunk-64 yardstick beside its bf16 figure.
# - float32 for hymba-1.5b, like mamba2-130m (32 layers of an SSM branch
#   beside attention carry the SSM's bf16 noise).
# - float32 for the MoE configurations: top-k routing is a step function,
#   so a token whose k-th and (k+1)-th router probabilities all but tie
#   takes another expert when its input moves by one bf16 unit, and its
#   logits move by far more than rounding noise. They also print how many
#   (token, layer) top-k sets differ between the kernel and plain runs.
# The MoE configurations run a prefix of their layers at full width: a
# whole model does not fit one card (dbrx-132b 1.32e11 parameters,
# arctic-480b 4.77e11; one layer ~3.3e9 = 13 GB and ~1.36e10 = 55 GB in
# float32).
LM_PATHS = {
    "tinyllama-1.1b": (None, ("flash_attention",), "bfloat16", 0),
    "mamba2-130m": (None, ("ssd_scan",), "float32", 32768),
    "hymba-1.5b": (None, ("flash_attention", "ssd_scan"), "float32", 0),
    "seamless-m4t-large-v2": (None, ("flash_attention",), "bfloat16", 0),
    "phi-3-vision-4.2b": (None, ("flash_attention",), "bfloat16", 0),
    "dbrx-132b": (2, ("flash_attention",), "float32", 0),
    "arctic-480b": (1, ("flash_attention",), "float32", 0),
}
FAMILIES = ("hymba-1.5b", "seamless-m4t-large-v2", "phi-3-vision-4.2b",
            "dbrx-132b", "arctic-480b")
# flash_attention at the shapes phase 12's prefills and decode steps give
# it: label, B, S, Sk, Hq, Hk, D, causal, window
FAMILY_ATTENTION = (
    ("phi-3-vision-4.2b prefill (D 96)", 2, 4096, 4096, 32, 32, 96, True,
     None),
    ("seamless-m4t-large-v2 encoder", 2, 2048, 2048, 16, 16, 64, False, None),
    ("seamless-m4t-large-v2 decoder self-attention", 2, 4096, 4096, 16, 16,
     64, True, None),
    ("seamless-m4t-large-v2 cross, prefill", 2, 4096, 2048, 16, 16, 64,
     False, None),
    ("seamless-m4t-large-v2 cross, decode step", 4, 1, 2048, 16, 16, 64,
     False, None),
    ("hymba-1.5b windowed prefill", 2, 4096, 4096, 25, 5, 64, True, 1024),
    ("dbrx-132b prefill", 2, 4096, 4096, 48, 8, 128, True, None),
    ("arctic-480b prefill (groups of 7)", 2, 4096, 4096, 56, 8, 128, True,
     None),
)


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


def family_batch(cfg, dev, B: int, S: int, rng, gen) -> dict:
    """A prefill batch of S positions a row: tokens, after 256 patch
    embeddings for the vision model (S - 256 tokens), or beside the
    encoder's ``n_frontend_tokens`` frame embeddings (2048) for the
    encoder-decoder. Embeddings are N(0, 1) from ``gen`` on the card."""
    import torch

    n_text = S - cfg.n_frontend_tokens if cfg.frontend == "vision" else S
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                    (B, n_text)),
                                       device=dev)}
    if cfg.frontend:
        key = "src" if cfg.enc_dec else "frontend"
        batch[key] = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                                 generator=gen, device=dev)
    return batch


@contextlib.contextmanager
def moe_routing():
    """Records each `moe_ffn` call's sorted top-k expert sets (numpy)."""
    import numpy as np

    from repro_torch.models import moe

    seen = []
    ffn = moe.moe_ffn

    def wrapped(x, p, **kw):
        _, e = moe.top_k(moe.router(x, p["w_router"])[0], kw["top_k"])
        seen.append(np.sort(e.cpu().numpy(), -1))
        return ffn(x, p, **kw)

    moe.moe_ffn = wrapped
    try:
        yield seen
    finally:
        moe.moe_ffn = ffn


def drive_lm_path(dev, name: str) -> dict:
    """Phases 6, 8 and 12: one configuration of `LM_PATHS` at full width on
    the card: prefill B 2 x 4096 positions with every count reset just
    before and read just after (and the extra B 1 prefill, if any); kernels
    vs plain versions at B 1 x 2048 in both compute types; the 4-slot
    server; one-slot decode after admission vs prefill in both types."""
    from dataclasses import replace

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
    from repro_torch.models.transformer import cross_kv, encoder_forward
    from repro_torch.serving.engine import GenRequest, ServingEngine

    n_layers, kernels, cmp_dtype, long_prompt = LM_PATHS[name]
    mods = {"flash_attention": fa, "ssd_scan": ssd, "dom_admit": admit_mod,
            "dom_release": release_mod, "inchash": inchash_mod}
    full = get_config(name)
    cfg = full if n_layers is None else replace(full, n_layers=n_layers)
    out = {"layers": cfg.n_layers, "of_layers": full.n_layers,
           "params": count_params(cfg), "full_params": count_params(full),
           "compare": cmp_dtype}
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    prefill = make_prefill(cfg)
    # launches per prefill: attention once per attention block (the
    # encoder-decoder: encoder, self and cross), the scan once per layer
    per_layer = {"flash_attention": 3 if cfg.enc_dec else 1, "ssd_scan": 1}
    want = {k: cfg.n_layers * per_layer[k] if k in kernels else 0
            for k in mods}
    routes = {"tensor_core": want["flash_attention"], "scalar": 0}

    def counted(batch) -> tuple:
        """One prefill with every count reset just before and read just
        after: logits, hidden, wall s, peak GB, launches, attention by
        route."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in mods.values():
            m.launches = 0
        fa.launches_tensor_core = fa.launches_scalar = 0
        t0 = time.perf_counter()
        logits, hidden = prefill(params, batch)
        torch.cuda.synchronize()
        return (logits, hidden, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 1e9,
                {k: m.launches for k, m in mods.items()},
                {"tensor_core": fa.launches_tensor_core,
                 "scalar": fa.launches_scalar})

    # the main path: B 2 x 4096 positions
    batch = family_batch(cfg, dev, 2, 4096, rng, gen)
    prefill(params, batch)                           # warm: cuBLAS, allocator
    (logits, hidden, out["prefill_s"], out["peak_gb"], out["launches"],
     out["attention_routes"]) = counted(batch)
    if out["launches"] != want or out["attention_routes"] != routes:
        raise RuntimeError(f"{name}'s prefill launched "
                           f"{out['launches']} (attention by route "
                           f"{out['attention_routes']}), not {want} with "
                           f"all attention on the tensor cores")
    if not (logits.shape == (2, cfg.vocab) and hidden.shape ==
            (2, 4096, cfg.d_model) and torch.isfinite(logits).all()
            and torch.isfinite(hidden).all()):
        raise RuntimeError(f"{name}'s prefill output has the wrong shape or "
                           f"is not finite")
    del logits, hidden, batch

    if long_prompt:
        long = family_batch(cfg, dev, 1, long_prompt, rng, gen)
        logits, hidden, wall, peak, launched, by_route = counted(long)
        out["long"] = {"tokens": long_prompt, "prefill_s": wall,
                       "peak_gb": peak, "launches": launched}
        if not (launched == want and by_route == routes
                and torch.isfinite(logits).all()
                and torch.isfinite(hidden).all()):
            raise RuntimeError(f"{name}'s S {long_prompt} prefill is not "
                               f"finite or launched {launched}, not {want}")
        del logits, hidden, long
        torch.cuda.empty_cache()

    # kernel vs plain versions through the model (B 1 x 2048), both types
    short = family_batch(cfg, dev, 1, 2048, rng, gen)

    def last_logits(plain: bool, chunk=None):
        """Last logits with the kernels, or with their plain versions
        (the plain scan at ``chunk`` in place of the config's, if given)."""
        saved = {k: getattr(mods[k], f"{k}_cuda") for k in kernels}
        if plain:
            for k in kernels:
                setattr(mods[k], f"{k}_cuda", getattr(mods[k], f"{k}_plain"))
            if chunk:
                setattr(ssd, "ssd_scan_cuda", lambda *a, chunk: (
                    ssd.ssd_scan_plain(*a, chunk=64)))
        try:
            return prefill(params, short)[0].float()
        finally:
            for k, fn in saved.items():
                setattr(mods[k], f"{k}_cuda", fn)

    out["prefill_vs_plain"] = {}
    for dtype in ("bfloat16", "float32"):
        with compute_dtype(dtype), moe_routing() as sets:
            kern, plain = last_logits(False), last_logits(True)
        res = {"max_abs_err": float((kern - plain).abs().max().cpu()),
               "max_abs_logit": float(plain.abs().max().cpu())}
        if cfg.family == "moe":
            half = len(sets) // 2
            res["topk_sets_differing"] = int(sum(
                (a != b).any(-1).sum() for a, b in zip(sets[:half],
                                                       sets[half:])))
        if dtype == "bfloat16" and "ssd_scan" in kernels:
            # two exact float32 orders of the plain scan, chunk 64 against
            # the config's chunk: the bf16 yardstick
            with compute_dtype(dtype):
                other = last_logits(True, chunk=64)
            res["plain_chunk64_vs_plain"] = float(
                (other - plain).abs().max().cpu())
            del other
        out["prefill_vs_plain"][dtype] = res
        del kern, plain
    gate = out["prefill_vs_plain"][cmp_dtype]
    gate["tol"] = gate["max_abs_logit"] * LM_REL_TOL
    if not (gate["max_abs_err"] <= gate["tol"]
            and gate.get("topk_sets_differing", 0) == 0):
        raise RuntimeError(f"{name}: prefill through the kernels disagrees "
                           f"with the plain prefill ({cmp_dtype}): {gate}")
    del short
    torch.cuda.empty_cache()

    # the continuous-batching server: 4 prompts of 32 tokens, 16 new each
    prompts = [rng.integers(0, cfg.vocab, 32).tolist() for _ in range(4)]
    engine = ServingEngine(cfg, params, n_slots=4, max_seq=256)
    torch.cuda.synchronize()
    fa.launches = 0
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
    steps = 4 * 32 + produced
    answers = [engine.requests[i].out for i in range(4)]
    if not all(len(a) == 16 and all(0 <= t < cfg.vocab for t in a)
               for a in answers):
        raise RuntimeError(f"the engine's answers are malformed: {answers}")
    # seamless: each decode step's cross-attention is one launch a layer
    if fa.launches != steps * cfg.n_layers * int(cfg.enc_dec):
        raise RuntimeError(f"serving launched flash_attention {fa.launches} "
                           f"times over {steps} decode steps")
    out["serve"] = {"wall_s": wall, "admit_s": t_admit, "decode_steps": steps,
                    "tokens": produced, "tokens_per_s": produced / wall,
                    "decode_tokens_per_s": produced / (wall - t_admit),
                    "attention_launches": fa.launches, "answers": answers}
    del engine
    torch.cuda.empty_cache()

    # a one-slot engine's decode logits after admitting prompt 0 ==
    # make_prefill's last logits for it (one slot: no cache overwrite).
    # MoE: prefill with a capacity that holds every assignment (prefill
    # drops past capacity, a decode step never does); seamless: the
    # engine's cross cache set to the cross K/V of prefill's frames; the
    # vision model: text only, as its decode step is
    one = {"tokens": torch.as_tensor([prompts[0]], device=dev)}
    if cfg.enc_dec:
        one["src"] = torch.randn((1, cfg.n_frontend_tokens, cfg.d_model),
                                 generator=gen, device=dev)
    pcfg = cfg if cfg.family != "moe" else replace(
        cfg, capacity_factor=2.0 * cfg.n_experts)
    out["decode_vs_prefill"] = {}
    for dtype in ("bfloat16", "float32"):
        with compute_dtype(dtype):
            last, _ = make_prefill(pcfg)(params, one)
            engine = ServingEngine(cfg, params, n_slots=1, max_seq=256)
            if cfg.enc_dec:
                engine.cache["cross"] = cross_kv(
                    params, encoder_forward(params, one["src"], cfg), cfg)
            seen, decode = [], engine.decode

            def recording(*args):
                step_logits, cache = decode(*args)
                seen.append(step_logits)
                return step_logits, cache

            engine.decode = recording
            engine.admit(GenRequest(seq_id=0, prompt=prompts[0], max_new=1))
        out["decode_vs_prefill"][dtype] = {
            "max_abs_err": float((seen[-1][0].float() - last[0].float())
                                 .abs().max().cpu()),
            "max_abs_logit": float(last.float().abs().max().cpu())}
        del engine, seen
    gate = out["decode_vs_prefill"][cmp_dtype]
    gate["tol"] = gate["max_abs_logit"] * LM_REL_TOL
    if not gate["max_abs_err"] <= gate["tol"]:
        raise RuntimeError(f"{name}: one-slot decode logits disagree with "
                           f"make_prefill's ({cmp_dtype}): {gate}")
    del params
    torch.cuda.empty_cache()
    return out


def lm_lines(name: str, r: dict) -> list:
    """The printed lines of one `drive_lm_path` run."""
    other = "float32" if r["compare"] == "bfloat16" else "bfloat16"
    lines = [f"{name} ({r['params']} parameters, {r['layers']} of "
             f"{r['of_layers']} layers; init {r['init_s']:.2f} s): prefill "
             f"B2 x S4096 {r['prefill_s']:.4f} s "
             f"({2 * 4096 / r['prefill_s']:.0f} tokens/s), launches {json.dumps(r['launches'])} "
             f"(flash_attention by route {json.dumps(r['attention_routes'])}),"
             f" peak {r['peak_gb']:.2f} GB"]
    if r["layers"] != r["of_layers"]:
        lines.append(f"  reduced: n_layers {r['of_layers']} -> {r['layers']}"
                     f" at full width ({r['full_params']} parameters in all "
                     f"do not fit one card)")
    if "long" in r:
        lg = r["long"]
        lines.append(f"  prefill B1 x S{lg['tokens']}: {lg['prefill_s']:.4f}"
                     f" s ({lg['tokens'] / lg['prefill_s']:.0f} tokens/s), "
                     f"launches {json.dumps(lg['launches'])}, peak "
                     f"{lg['peak_gb']:.2f} GB")
    for key, label in (("prefill_vs_plain", "prefill B1 x S2048, kernels vs "
                        "plain versions"),
                       ("decode_vs_prefill", "one-slot decode after "
                        "admitting a 32-token prompt vs make_prefill")):
        g, o = r[key][r["compare"]], r[key][other]
        line = (f"  {label}, {r['compare']} compute (the gate): last logits "
                f"max abs err {g['max_abs_err']:.4g} (largest "
                f"{g['max_abs_logit']:.4g}, tolerance {g['tol']:.4g}); "
                f"{other}: {o['max_abs_err']:.4g} (largest "
                f"{o['max_abs_logit']:.4g})")
        if "topk_sets_differing" in g:
            line += (f"; (token, layer) top-k sets differing between the "
                     f"runs: {r['compare']} {g['topk_sets_differing']}, "
                     f"{other} {o['topk_sets_differing']}")
        bf = r[key]["bfloat16"]
        if "plain_chunk64_vs_plain" in bf:
            line += (f"; in bf16 the plain scan at chunk 64 vs the config's "
                     f"chunk differs by {bf['plain_chunk64_vs_plain']:.4g}")
        lines.append(line)
    sv = r["serve"]
    lines.append(
        f"  ServingEngine(n_slots=4, max_seq=256): 4 prompts x 32 tokens, "
        f"{sv['tokens']} new tokens in {sv['wall_s']:.3f} s "
        f"({sv['tokens_per_s']:.2f} tokens/s; {sv['decode_steps']} decode "
        f"steps, admission {sv['admit_s']:.3f} s, decode ticks "
        f"{sv['decode_tokens_per_s']:.2f} tokens/s; flash_attention "
        f"launches {sv['attention_launches']}); first answer "
        f"{sv['answers'][0]}")
    return lines


def drive_main_path(device: str, rate: float, duration: float,
                    sanitize: bool = False):
    from repro_torch.core import VectorizedConfig, make_cluster
    from repro_torch.sim.workload import Workload, WorkloadDriver

    # client_timeout 1 s keeps 16-epoch windows retry-closed (a window runs
    # only while no attempt inside it can time out and retry)
    cfg = VectorizedConfig(f=1, n_clients=1, n_proxies=1, seed=0,
                           epoch_duration=10e-3, epochs_per_dispatch=16,
                           commutative=True, client_timeout=1.0,
                           device=device, sanitize=sanitize)
    cluster = make_cluster("nezha-vectorized", cfg)
    work = Workload(mode="open", rate_per_client=rate, duration=duration,
                    read_ratio=0.5, skew=0.5, n_keys=1_000_000, seed=0)
    t0 = time.perf_counter()
    summary = WorkloadDriver(work).run(cluster)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    return cluster, summary, time.perf_counter() - t0


def main_path_difference(a_cl, a_sum: dict, b_cl, b_sum: dict):
    """The first difference between two runs of the main path (summary but
    ``tier`` and ``backend``, commit latencies, commit trace, replica
    log), or None."""
    import numpy as np

    for key, value in a_sum.items():
        if key in ("tier", "backend"):
            continue
        same = (value == b_sum[key]) or (
            isinstance(value, float) and np.isnan(value)
            and np.isnan(b_sum[key]))
        if not same:
            return f"summary[{key!r}]: {value!r} against {b_sum[key]!r}"
    if np.concatenate(a_cl._latencies).tobytes() != \
            np.concatenate(b_cl._latencies).tobytes():
        return "commit latencies"
    if len(a_cl._trace_commits) != len(b_cl._trace_commits):
        return "commit trace length"
    for (ta, *ua), (tb, *ub) in zip(a_cl._trace_commits,
                                    b_cl._trace_commits):
        if ta.tobytes() != tb.tobytes() or any(
                np.asarray(x).tobytes() != np.asarray(y).tobytes()
                for x, y in zip(ua, ub)):
            return "commit trace (times, uids, fast flags)"
    log_a = a_cl.engine.logs.log_columns()
    log_b = b_cl.engine.logs.log_columns()
    for col in log_a:
        if log_a[col].tobytes() != log_b[col].tobytes():
            return f"replica log column {col!r}"
    return None


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


def profile_lm_path(dev, arch: str, n_layers=None) -> None:
    """Where an LM path's card time goes: one B 2 x 4096-position prefill
    (phase 12's batch: frames or patches where the config takes them) and
    eight decode steps of a 4-slot engine, each under torch.profiler after
    a warm run (device time by kernel, device busy share of the wall).
    ``n_layers`` cuts the depth, as phase 12 does for the MoE configs."""
    from dataclasses import replace

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, make_prefill
    from repro_torch.serving.engine import GenRequest, ServingEngine

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = init_params(cfg, seed=0, device=dev)
    prefill = make_prefill(cfg)
    batch = family_batch(cfg, dev, 2, 4096, rng, gen)
    engine = ServingEngine(cfg, params, n_slots=4, max_seq=256)
    for i in range(4):
        engine.admit(GenRequest(seq_id=i, max_new=64,
                                prompt=rng.integers(0, cfg.vocab, 8).tolist()))
    runs = (("prefill B2 x S4096", lambda: prefill(params, batch)),
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
    every epoch with requests, whether single or inside a K-epoch window
    (a batched dispatch of G groups: its most lanes)."""
    from repro_torch.core.engine import DomEngine

    lanes = []
    make_body = DomEngine._body

    def probed(self, use_kcls, use_cap):
        body = make_body(self, use_kcls, use_cap)

        def run(*args, **kw):
            # args[11]: the valid lanes of each group; args[3]: t [G, n_pad]
            lanes.append((max(int(n) for n in args[11]),
                          int(args[3].shape[-1])))
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


def same_runs(a: dict, b: dict, what: str) -> None:
    """Two scenario runs equal bit for bit: every result key and raw
    summary key but ``tier``, the commit trace, and the findings."""
    from repro_torch.sim.scenario import SCENARIO_RESULT_KEYS

    name = a["res"].scenario
    pairs = [(k, getattr(a["res"], k), getattr(b["res"], k))
             for k in SCENARIO_RESULT_KEYS if k != "tier"]
    pairs.append(("raw", {k: v for k, v in a["res"].raw.items()
                          if k != "tier"},
                  {k: v for k, v in b["res"].raw.items() if k != "tier"}))
    pairs += [(p, getattr(a["trace"], p), getattr(b["trace"], p))
              for p in TRACE_PARTS]
    pairs.append(("findings", findings(a["trace"]), findings(b["trace"])))
    for key, x, y in pairs:
        d = first_difference(x, y, key)
        if d is not None:
            raise RuntimeError(f"{name}: {what} differ at {d}")


def card_equals_cpu(card: dict, cpu: dict) -> None:
    """Card run == CPU run, bit for bit (`same_runs`), on their tiers."""
    name = card["res"].scenario
    same_runs(card, cpu, "the card and the CPU")
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
    card_runs = {}
    t_phase = time.perf_counter()
    for name in sc_mod.available_scenarios():
        card = run_scenario_traced(name, "cuda")
        cpu = run_scenario_traced(name, "cpu")
        card_equals_cpu(card, cpu)
        card_runs[name] = card
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
    return {"totals": totals, "walls": walls, "catalog_s": catalog_s,
            "card_runs": card_runs}


# Phase 11: nezha-sharded (`repro_torch.core.sharded`). The DOM kernels'
# batched form at (G, padded lanes, requests a group): the deployment's
# per-group epochs at G 4, 16 and 64 on the small route, and two groups of
# G 1's epoch on the onesweep route.
SHARDED_SHAPES = ((4, 16_384, 15_625), (16, 4_096, 3_907), (64, 1_024, 977),
                  (2, 65_536, 62_500))
# benchmarks/dom_scale.py::_bench_sharded at N 1e6: single-key writes, keys
# uniform over 2^20, submit times uniform over 16 epochs of 10 ms, 64
# clients, 3 replicas a group, seed 0; 2 epochs warm, the rest timed
SHARDED_N = 1_000_000
SHARDED_EPOCHS = 16
SHARDED_WARM_EPOCHS = 2
SHARDED_GROUPS = (1, 4, 16, 64)
SHARDED_SCENARIOS = ("sharded-multi-key", "sharded-group-crash")


def group_batch(G: int, n_pad: int, n_valid: int, seed: int):
    """G realistic DOM batches of n_valid requests, +inf padding lanes to
    n_pad, as the sharded epoch stacks them."""
    import numpy as np

    d = np.full((G, n_pad), np.inf)
    a = np.full((G, n_pad, 3), np.inf)
    for g in range(G):
        d[g, :n_valid], a[g, :n_valid] = realistic_batch(n_valid, 3,
                                                         seed + g)
    return d, a


def check_batched(dev, G: int, n_pad: int, n_valid: int) -> dict:
    """Both DOM kernels batched over G groups (one launch for all G) ==
    their plain versions on the same [G, ...] tensors, exactly, and == G
    separate launches of the G 1 form; timed per call (eager, and from a
    CUDA graph) beside the G separate launches, the plain version, the
    byte bound and (dom_release) one stable `torch.sort` of the [G, n]
    keys along its rows."""
    import numpy as np
    import torch

    from repro_torch.kernels.dom_admit import (admit_route, dom_admit,
                                               dom_admit_plain)
    from repro_torch.kernels.dom_release import (dom_release,
                                                 dom_release_plain,
                                                 release_route,
                                                 small_route_blocks)
    from repro_torch.kernels.timekeys import time_sort_keys

    d_np, a_np = group_batch(G, n_pad, n_valid, seed=G)
    d = torch.as_tensor(d_np, device=dev)
    a = torch.as_tensor(a_np, device=dev)
    R = a.shape[2]
    ones = torch.ones((G, n_pad), dtype=torch.bool, device=dev)
    inf = float("inf")
    adm_k = dom_admit(d, a)
    adm_p = dom_admit_plain(d, a)
    torch.cuda.synchronize()
    admit_err = int((adm_k.to(torch.int32) - adm_p.to(torch.int32))
                    .abs().max())
    if not torch.equal(adm_k, adm_p):
        raise RuntimeError(f"batched dom_admit disagrees with its plain "
                           f"version at G {G} x {n_pad}")
    release_err = 0
    now = float(np.median(d_np[0, :n_valid]))
    for adm, clock in ((ones, inf), (adm_k[..., 0], now)):
        o_k, c_k = dom_release(d, adm, clock)
        o_p, c_p = dom_release_plain(d, adm, clock)
        torch.cuda.synchronize()
        release_err = max(release_err, int((o_k.to(torch.int64)
                                            - o_p.to(torch.int64))
                                           .abs().max()))
        if not (torch.equal(o_k, o_p) and torch.equal(c_k, c_p)):
            raise RuntimeError(f"batched dom_release disagrees with its "
                               f"plain version at G {G} x {n_pad}")

    def admit_each():
        return [dom_admit(d[g], a[g]) for g in range(G)]

    def release_each():
        return [dom_release(d[g], ones[g], inf) for g in range(G)]

    order = dom_release(d, ones, inf)[0]
    for g, (x, (y, _)) in enumerate(zip(admit_each(), release_each())):
        if not (torch.equal(x, adm_k[g]) and torch.equal(y, order[g])):
            raise RuntimeError(f"group {g}'s own launch disagrees with the "
                               f"batched one at G {G} x {n_pad}")
    keys = time_sort_keys(d)
    out = {"G": G, "n": n_pad, "requests": n_valid, "R": R,
           "cluster_blocks": (small_route_blocks(n_pad)
                              if release_route(n_pad) == "small" else None)}
    out["dom_admit"] = {
        "route": admit_route(n_pad), "max_abs_err": admit_err,
        "ms": time_ms(lambda: dom_admit(d, a)),
        "graph_ms": time_graph_ms(lambda: dom_admit(d, a)),
        "separate_ms": time_ms(admit_each),
        "separate_graph_ms": time_graph_ms(admit_each),
        "plain_ms": time_ms(lambda: dom_admit_plain(d, a)),
        "bound_ms": G * (8 * n_pad + 8 * R * n_pad + R * n_pad)
        / HBM_BYTES_PER_S * 1e3,
        "library_ms": None}
    call = lambda: dom_release(d, ones, inf)              # noqa: E731
    lib = lambda: torch.sort(keys, dim=1, stable=True)    # noqa: E731
    out["dom_release"] = {
        "route": release_route(n_pad), "max_abs_err": release_err,
        "ms": time_ms(call), "graph_ms": time_graph_ms(call),
        "separate_ms": time_ms(release_each),
        "separate_graph_ms": time_graph_ms(release_each),
        "plain_ms": time_ms(lambda: dom_release_plain(d, ones, inf)),
        "bound_ms": G * (9 * n_pad + 4 * n_pad) / HBM_BYTES_PER_S * 1e3,
        "library_ms": time_ms(lib), "library_graph_ms": time_graph_ms(lib)}
    for name in ("dom_admit", "dom_release"):
        r = out[name]
        r["bound_share"] = r["bound_ms"] / r["ms"]
    return out


def batched_line(r: dict, name: str) -> str:
    def f(x):
        return "-" if x is None else f"{x:.4f}"
    k = r[name]
    blocks = ("" if r["cluster_blocks"] is None
              else f" ({r['cluster_blocks']}-block clusters)")
    line = (f"  {name:<11s} G {r['G']:<3d} x {r['n']:<6d} ({r['requests']} "
            f"requests a group) route {k['route']}{blocks}, one launch "
            f"{k['ms']:.4f} ms (graph {f(k['graph_ms'])}), {r['G']} "
            f"separate launches {k['separate_ms']:.4f} (graph "
            f"{f(k['separate_graph_ms'])}), plain {k['plain_ms']:.4f}, "
            f"bound {k['bound_ms']:.6f} (bytes), share of bound "
            f"{k['bound_share']:.4f}")
    if k["library_ms"] is not None:
        line += (f", stable torch.sort of the rows {k['library_ms']:.4f} "
                 f"(graph {f(k['library_graph_ms'])})")
    return line


def sharded_workload():
    """The deployment's requests, made as `_bench_sharded` makes them."""
    import numpy as np

    rng = np.random.default_rng(0)
    duration = SHARDED_EPOCHS * 10e-3
    t = np.sort(rng.uniform(0.0, duration, SHARDED_N)).tolist()
    cid = rng.integers(0, 64, SHARDED_N).tolist()
    keys = rng.integers(0, 1 << 20, SHARDED_N, dtype=np.uint64).tolist()
    return t, cid, keys


def run_deployment(name: str, G: int, device: str, batched: bool,
                   work, sanitize: bool = False) -> dict:
    """One run of the deployment: submit every request, run 2 epochs warm
    and the rest timed, with the DOM launch counts reset just before the
    run and read just after, every body dispatch probed, and (batched) the
    per-group retry generations counted; ``sanitize`` switches on the
    runtime invariant sanitizer."""
    import torch

    from repro_torch.core import ShardedConfig, make_cluster
    from repro_torch.core.messages import OpType

    epoch = 10e-3
    duration = SHARDED_EPOCHS * epoch
    cfg = ShardedConfig(groups=G, n_clients=64, seed=0, device=device,
                        vmap_groups=batched, sanitize=sanitize)
    cl = make_cluster(name, cfg)
    t0 = time.perf_counter()
    for ti, ci, ki in zip(*work):
        cl.submit_at(ti, ci, keys=(ki,), op=OpType.WRITE)
    submit_s = time.perf_counter() - t0
    gens = [0]
    for grp in getattr(cl, "groups", ()):
        run_epoch = grp.engine.run_epoch

        def counted(*args, _run=run_epoch, **kw):
            gens[0] += 1
            return _run(*args, **kw)
        grp.engine.run_epoch = counted
    reset_dom_counts()
    with dispatch_probe() as lanes:
        t1 = time.perf_counter()
        cl.run_for(SHARDED_WARM_EPOCHS * epoch)
        if device == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        cl.run_for(duration - SHARDED_WARM_EPOCHS * epoch + 0.05)
        if device == "cuda":
            torch.cuda.synchronize()
        t3 = time.perf_counter()
    return {"cluster": cl, "summary": cl.summary(), "submit_s": submit_s,
            "warm_s": t2 - t1, "timed_s": t3 - t2, "counts": dom_counts(),
            "dispatches": len(lanes), "gens": gens[0],
            "max_lanes": max((n for n, _ in lanes), default=0),
            "max_padded": max((p for _, p in lanes), default=0)}


def sharded_state(cl) -> dict:
    """Everything a sharded run leaves to compare: the merged latencies and
    every group's commit trace (`ShardedTrace`, part by part)."""
    from repro_torch.sim.trace import CommitTrace

    tr = CommitTrace.from_cluster(cl)
    lat, n_fast = cl._merged_latencies()
    return {"latencies": lat, "n_fast": n_fast, "multiops": tr.multiops,
            "groups": [{p: getattr(g, p) for p in TRACE_PARTS}
                       for g in tr.groups]}


def deployment_line(r: dict, label: str) -> str:
    s = r["summary"]
    return (f"  {label}: {s['n_requests']} requests, {s['committed']} "
            f"committed, fast ratio {s['fast_commit_ratio']:.4f}, median "
            f"{s['median_latency'] * 1e6:.1f} us, {r['dispatches']} body "
            f"dispatches (most lanes {r['max_lanes']}, bucket "
            f"{r['max_padded']}), {s.get('vmap_epochs', 0)} batched epochs "
            f"+ {r['gens'] if s.get('vmap_epochs') else 0} retry "
            f"generations, dom_admit {json.dumps(r['counts']['dom_admit'])} "
            f"dom_release {json.dumps(r['counts']['dom_release'])}; wall: "
            f"submit {r['submit_s']:.3f} s, warm {r['warm_s']:.3f} s, timed "
            f"{r['timed_s']:.3f} s ({s['committed'] / r['timed_s']:.0f} "
            f"committed/s over the timed wall)")


def check_launches(r: dict, label: str, batched: bool) -> None:
    """Each DOM kernel launched on the run, once a body dispatch: batched,
    once a lockstep epoch with work plus once a retry generation."""
    want = r["dispatches"]
    if batched:
        want = r["summary"]["vmap_epochs"] + r["gens"]
        if r["summary"]["vmap_epochs"] <= 0 or want != r["dispatches"]:
            raise RuntimeError(f"{label}: {r['summary']['vmap_epochs']} "
                               f"batched epochs, {r['gens']} retry "
                               f"generations, {r['dispatches']} dispatches")
    for name, by_route in r["counts"].items():
        got = sum(by_route.values())
        if got <= 0 or got != want:
            raise RuntimeError(f"{label}: {name} launched "
                               f"{json.dumps(by_route)}, want {want}")


def drive_sharded(dev) -> dict:
    """Phase 11: the batched DOM kernels against their plain versions, the
    deployment of `_bench_sharded` at G 1, 4, 16 and 64 (sequential ==
    batched, G 1 == nezha-vectorized, card == CPU at G 16), and the two
    sharded scenarios, card == CPU."""
    import numpy as np

    from repro_torch.sim.scenario import SCENARIO_RESULT_KEYS
    from repro_torch.sim.trace import (check_cross_group_linearizability,
                                       run_scenario_with_trace)

    print("nezha-sharded: the DOM kernels batched over G groups, one launch "
          "for all G (== plain and == G separate launches, bit for bit):")
    batched = [check_batched(dev, G, n, req) for G, n, req in SHARDED_SHAPES]
    for name in ("dom_admit", "dom_release"):
        for r in batched:
            print(batched_line(r, name))

    print(f"nezha-sharded deployment (benchmarks/dom_scale.py "
          f"_bench_sharded): {SHARDED_N} single-key writes over 2^20 keys in "
          f"{SHARDED_EPOCHS} epochs of 10 ms, 64 clients, 3 replicas a "
          f"group, seed 0:")
    work = sharded_workload()
    runs = {}
    base = run_deployment("nezha-vectorized", 1, "cuda", False, work)
    one = run_deployment("nezha-sharded", 1, "cuda", False, work)
    print(deployment_line(base, "nezha-vectorized G 1"))
    print(deployment_line(one, "nezha-sharded G 1   "))
    sa, sb = base["summary"], one["summary"]
    diff = [k for k in sa if k not in ("protocol", "backend")
            and first_difference(sa[k], sb.get(k)) is not None]
    grp, vec = one["cluster"].groups[0], base["cluster"]
    same = not diff and all(
        first_difference(x, y) is None for x, y in (
            (np.concatenate(grp._latencies), np.concatenate(vec._latencies)),
            ([list(r) for r in grp._trace_commits],
             [list(r) for r in vec._trace_commits]),
            (grp.engine.logs.log_columns(), vec.engine.logs.log_columns())))
    if not same:
        raise RuntimeError(f"nezha-sharded G 1 differs from nezha-vectorized"
                           f": {diff or 'latencies, commits or log'}")
    check_launches(one, "G 1", False)
    runs[1] = {"sequential": one}
    print("  G 1: nezha-sharded == nezha-vectorized, bit for bit (summary, "
          "latencies, commit trace, replica log)")
    del base
    for G in SHARDED_GROUPS[1:]:
        seq = run_deployment("nezha-sharded", G, "cuda", False, work)
        bat = run_deployment("nezha-sharded", G, "cuda", True, work)
        print(deployment_line(seq, f"G {G:<2d} sequential"))
        print(deployment_line(bat, f"G {G:<2d} batched   "))
        check_launches(seq, f"G {G} sequential", False)
        check_launches(bat, f"G {G} batched", True)
        want = sharded_state(bat["cluster"])
        pairs = [("sequential", seq)]
        if G == 16:
            cpu = run_deployment("nezha-sharded", G, "cpu", True, work)
            print(deployment_line(cpu, f"G {G:<2d} batched on the CPU"))
            if any(sum(c.values()) for c in cpu["counts"].values()):
                raise RuntimeError("the CPU run launched a kernel")
            pairs.append(("the CPU", cpu))
        for label, other in pairs:
            keep = ("vmap_epochs", "tier")
            d = first_difference(
                {k: v for k, v in bat["summary"].items() if k not in keep},
                {k: v for k, v in other["summary"].items() if k not in keep},
                "summary")
            d = d or first_difference(want, sharded_state(other["cluster"]))
            if d is not None:
                raise RuntimeError(f"G {G}: batched on the card differs from "
                                   f"{label} at {d}")
        print(f"  G {G}: batched == " + " == ".join(p for p, _ in pairs)
              + ", bit for bit (summary, merged latencies, every group's "
              "commit trace)")
        runs[G] = {"sequential": seq, "batched": bat}
        for r in (seq, bat):
            r.pop("cluster")
        if G == 16:
            cpu.pop("cluster")
            runs[G]["cpu"] = cpu
            g16_state = want        # phase 15 holds its sanitized run to it
    one.pop("cluster")

    print("the two sharded scenarios, card == CPU (bit for bit):")
    scenarios = {}
    for name in SHARDED_SCENARIOS:
        out = {}
        for device in ("cuda", "cpu"):
            reset_dom_counts()
            t0 = time.perf_counter()
            res, tr = run_scenario_with_trace("nezha-sharded", name,
                                              device=device)
            out[device] = (res, tr, time.perf_counter() - t0, dom_counts())
        (rg, tg, wg, cg), (rc, tc, wc, _) = out["cuda"], out["cpu"]
        pairs = [(k, getattr(rg, k), getattr(rc, k))
                 for k in SCENARIO_RESULT_KEYS if k != "tier"]
        pairs.append(("raw", {k: v for k, v in rg.raw.items() if k != "tier"},
                      {k: v for k, v in rc.raw.items() if k != "tier"}))
        pairs += [(f"group {g} {p}", getattr(a, p), getattr(b, p))
                  for g, (a, b) in enumerate(zip(tg.groups, tc.groups))
                  for p in TRACE_PARTS]
        pairs += [("multiops", tg.multiops, tc.multiops),
                  ("findings", findings(tg), findings(tc))]
        for key, x, y in pairs:
            d = first_difference(x, y, key)
            if d is not None:
                raise RuntimeError(f"{name}: the card and the CPU differ at "
                                   f"{d}")
        vc = rg.raw["per_group_view_changes"]
        xg = check_cross_group_linearizability(tg)
        print(f"  {name}: {rg.n_requests} requests, {rg.committed} "
              f"committed, fast ratio {rg.fast_commit_ratio:.4f}, "
              f"cross-group ops {rg.raw['cross_group_ops']}, per-group view "
              f"changes {vc}, skipped faults {rg.skipped_faults}, "
              f"cross-group findings {len(xg)}, dom_admit "
              f"{json.dumps(cg['dom_admit'])} dom_release "
              f"{json.dumps(cg['dom_release'])}, wall card {wg:.3f} s, CPU "
              f"{wc:.3f} s")
        if rg.skipped_faults != 0 or rg.tier != "torch-cuda":
            raise RuntimeError(f"{name}: skipped {rg.skipped_faults} "
                               f"faults on {rg.tier}")
        if name == "sharded-group-crash" and vc != [0, 1, 0, 0]:
            raise RuntimeError(f"{name}: per-group view changes {vc}")
        if name == "sharded-multi-key" and (xg or not tg.multiops):
            raise RuntimeError(f"{name}: the cross-group checker found "
                               f"{xg[:3]} in {len(tg.multiops)} multi-ops")
        if any(sum(c.values()) <= 0 for c in cg.values()):
            raise RuntimeError(f"{name}: a DOM kernel never launched")
        scenarios[name] = {"card_s": wg, "cpu_s": wc,
                           "launches_by_route": cg}
    return {"batched": batched, "runs": runs, "scenarios": scenarios,
            "g16_state": g16_state}


# Phase 13: the replicated LM service at full width (random weights from
# seed 0, f 1: three replicas on the card, the service's defaults n_slots 4
# and max_seq 128) answering 4 prompts of 8 tokens with 8 new tokens each,
# then the failover of the reference's service test; the backend
# cross-check of benchmarks/figs.py (event `nezha` on the host beside
# `nezha-vectorized` on the card); and Fig 9's "full" operating point on
# `nezha` and `nezha-nonproxy` (host code).
SERVICE_ARCHS = ("tinyllama-1.1b", "seamless-m4t-large-v2")
SERVICE_PROMPTS, SERVICE_PROMPT_LEN, SERVICE_MAX_NEW = 4, 8, 8
CROSSCHECK_RATES = (1000.0, 5000.0)     # req/s a client, 10 clients, 0.2 s
FIG9_RATE, FIG9_DURATION = 2000.0, 0.25  # 10 clients, 3 proxies


def drive_service(dev, cfg, name: str) -> dict:
    """Phase 13: `ReplicatedLMService` on ``cfg`` with the engines on the
    card. The flash_attention counts are reset just before the service
    is built and read after the failover: each decode step of an
    encoder-decoder launches the cross attention once a layer, on the
    tensor cores; a decoder-only model's decode steps launch none. The
    replicas' fingerprints must agree, the tokens must equal a lone
    `ServingEngine`'s fed the same ADMIT/TICK sequence (run after the
    counts are read), and the results must survive the leader's crash."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import (GenRequest, ReplicatedLMService,
                                            ServingEngine)

    out = {"name": name}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, SERVICE_PROMPT_LEN).tolist()
               for _ in range(SERVICE_PROMPTS)]
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_tensor_core = fa.launches_scalar = 0
    t0 = time.perf_counter()
    svc = ReplicatedLMService(cfg, params, f=1, seed=0)
    ids = [svc.submit_prompt(p, max_new=SERVICE_MAX_NEW) for p in prompts]
    ticks = [svc.step() for _ in range(SERVICE_MAX_NEW)]
    before = [tuple(svc.result(i)) for i in ids]
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t0
    svc.cluster.run_for(0.05)       # followers execute to the commit point
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    reps = svc.cluster.replicas
    caught_up = [r.executed_point == len(r.synced) for r in reps]
    fingerprints = [r.sm.engine.state_fingerprint() for r in reps]
    out["steps_per_replica"] = [r.sm.engine.n_steps for r in reps]
    s = svc.cluster.summary()
    out["summary"] = {k: s[k] for k in ("n_requests", "committed",
                                        "fast_commit_ratio",
                                        "median_latency", "p90_latency")}
    old = svc.cluster.leader_id
    t1 = time.perf_counter()
    svc.cluster.crash_replica(old)
    svc.cluster.run_for(0.2)
    after = [tuple(svc.result(i)) for i in ids]
    torch.cuda.synchronize()
    out["failover_s"] = time.perf_counter() - t1
    out["leaders"] = (old, svc.cluster.leader_id)
    out["view_changes"] = svc.cluster.summary()["view_changes"]
    out["launches"] = fa.launches
    out["attention_routes"] = {"tensor_core": fa.launches_tensor_core,
                               "scalar": fa.launches_scalar}
    out["decode_steps"] = sum(e.n_steps for e in svc.engines_made)
    out["engines_made"] = len(svc.engines_made)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["tokens"] = [list(t) for t in before]
    gen_tokens = SERVICE_PROMPTS * SERVICE_MAX_NEW
    out["tokens_per_s"] = gen_tokens / out["serve_s"]

    lone = ServingEngine(cfg, params, n_slots=4, max_seq=128)
    for i, p in enumerate(prompts):
        lone.admit(GenRequest(seq_id=i, prompt=p, max_new=SERVICE_MAX_NEW))
    for _ in range(SERVICE_MAX_NEW):
        lone.tick()
    lone_out = [tuple(lone.requests[i].out) for i in range(SERVICE_PROMPTS)]

    want = out["decode_steps"] * cfg.n_layers * int(cfg.enc_dec)
    problems = []
    if any(e.device != torch.device(dev) for e in svc.engines_made):
        problems.append("an engine is not on the card")
    if not all(caught_up):
        problems.append(f"replicas not caught up: {caught_up}")
    if len(set(fingerprints)) != 1 or fingerprints[0] != \
            lone.state_fingerprint() or ticks[-1][2] != fingerprints[0]:
        problems.append("the replicas' state fingerprints disagree with "
                        "each other or with the lone engine")
    if before != lone_out:
        problems.append(f"the service's tokens {before} differ from the "
                        f"lone engine's {lone_out}")
    if not all(len(t) == SERVICE_MAX_NEW and all(0 <= x < cfg.vocab
                                                 for x in t) for t in before):
        problems.append(f"malformed answers {before}")
    if after != before or out["leaders"][1] == old:
        problems.append(f"failover changed the results or kept the leader: "
                        f"{before} -> {after}, leaders {out['leaders']}")
    if s["committed"] != s["n_requests"] or s["committed"] != (
            2 * SERVICE_PROMPTS + SERVICE_MAX_NEW):
        problems.append(f"the cluster committed {s['committed']} of "
                        f"{s['n_requests']} commands")
    if out["launches"] != want or out["attention_routes"] != {
            "tensor_core": want, "scalar": 0}:
        problems.append(f"flash_attention launched {out['launches']} "
                        f"({out['attention_routes']}) for "
                        f"{out['decode_steps']} decode steps, not {want} on "
                        f"the tensor cores")
    if problems:
        raise RuntimeError(f"replicated {name}: " + "; ".join(problems))
    del svc, lone, params
    torch.cuda.empty_cache()
    return out


def service_line(r: dict, card: str) -> str:
    sm = r["summary"]
    return (f"replicated {r['name']} (3 replicas, {card}): "
            f"{SERVICE_PROMPTS} prompts x {SERVICE_PROMPT_LEN} tokens -> "
            f"{SERVICE_MAX_NEW} new each in {r['serve_s']:.3f} s "
            f"({r['tokens_per_s']:.2f} generated tokens/s; wall with the "
            f"followers' catch-up {r['wall_s']:.3f} s; init {r['init_s']:.2f}"
            f" s), decode steps per replica {r['steps_per_replica']}, "
            f"committed {sm['committed']} of {sm['n_requests']}, fast ratio "
            f"{sm['fast_commit_ratio']:.4f}, median commit "
            f"{sm['median_latency'] * 1e6:.1f} us; failover (leader "
            f"{r['leaders'][0]} -> {r['leaders'][1]}) {r['failover_s']:.3f} s,"
            f" results unchanged; flash_attention {r['launches']} launches "
            f"over {r['decode_steps']} decode steps of {r['engines_made']} "
            f"engines ({json.dumps(r['attention_routes'])}); peak "
            f"{r['peak_gb']:.2f} GB; replicas == lone engine, bit for bit; "
            f"first answer {r['tokens'][0]}")


def drive_crosscheck() -> list:
    """Phase 13: benchmarks/figs.py's backend cross-check at its quick
    settings. The vectorized run's DOM counts are reset just before and
    read just after: one launch of each kernel per epoch with requests.
    The event run launches none. Both must commit every request."""
    import torch

    from repro_torch.core import CommonConfig, VectorizedConfig, make_cluster
    from repro_torch.sim.workload import Workload, WorkloadDriver

    rows = []
    for rate in CROSSCHECK_RATES:
        work = Workload(mode="open", rate_per_client=rate, duration=0.2,
                        seed=0)
        row = {"rate": rate}
        for name in ("nezha", "nezha-vectorized"):
            # the event backend promotes the bare CommonConfig, as the
            # benchmark does; the vectorized one is the same fields
            cfg = (CommonConfig(f=1, n_clients=10, seed=0) if name == "nezha"
                   else VectorizedConfig(f=1, n_clients=10, seed=0))
            reset_dom_counts()
            with dispatch_probe() as lanes:
                t0 = time.perf_counter()
                s = WorkloadDriver(work).run(make_cluster(name, cfg))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = dom_counts()
            want = len(lanes) if name == "nezha-vectorized" else 0
            for kernel, by_route in counts.items():
                if sum(by_route.values()) != want:
                    raise RuntimeError(
                        f"cross-check {name}@{rate:.0f}: {kernel} launched "
                        f"{json.dumps(by_route)} for {len(lanes)} epochs "
                        f"with requests (want {want})")
            if name == "nezha-vectorized" and not (
                    len(lanes) > 0 and len(lanes) == s["batches"]):
                raise RuntimeError(f"cross-check: {len(lanes)} dispatches "
                                   f"for {s['batches']} epochs with "
                                   f"requests")
            if not s["n_requests"] > 0 or s["committed"] != s["n_requests"]:
                raise RuntimeError(f"cross-check {name}@{rate:.0f}: "
                                   f"committed {s['committed']} of "
                                   f"{s['n_requests']}")
            row[name] = {"n_requests": s["n_requests"],
                         "committed": s["committed"],
                         "median_latency": s["median_latency"],
                         "fast_commit_ratio": s["fast_commit_ratio"],
                         "wall_s": wall, "epochs_with_requests": len(lanes),
                         "launches_by_route": counts,
                         "tier": s.get("tier", s["backend"])}
        rows.append(row)
    return rows


def crosscheck_line(row: dict) -> str:
    ev, vec = row["nezha"], row["nezha-vectorized"]
    return (f"  {row['rate']:.0f} req/s a client: {ev['committed']} of "
            f"{ev['n_requests']} committed on both; median "
            f"{ev['median_latency'] * 1e6:.1f} us (nezha, host) vs "
            f"{vec['median_latency'] * 1e6:.1f} us (nezha-vectorized, "
            f"{vec['tier']}); fast ratio {ev['fast_commit_ratio']:.4f} vs "
            f"{vec['fast_commit_ratio']:.4f}; wall {ev['wall_s']:.3f} s vs "
            f"{vec['wall_s']:.3f} s; {vec['epochs_with_requests']} epochs "
            f"with requests, DOM launches "
            f"{json.dumps(vec['launches_by_route'])}")


def drive_fig9() -> dict:
    """Phase 13: Fig 9's "full" configuration (benchmarks/figs.py) on the
    two event-driven Nezha backends, host code. Every request commits."""
    from repro_torch.core import ClusterConfig, make_cluster
    from repro_torch.sim.workload import Workload, WorkloadDriver

    out = {}
    for name in ("nezha", "nezha-nonproxy"):
        cfg = ClusterConfig(f=1, n_proxies=3, n_clients=10, seed=0)
        work = Workload(mode="open", rate_per_client=FIG9_RATE,
                        duration=FIG9_DURATION, seed=0)
        t0 = time.perf_counter()
        s = WorkloadDriver(work).run(make_cluster(name, cfg))
        wall = time.perf_counter() - t0
        if not s["n_requests"] > 0 or s["committed"] != s["n_requests"]:
            raise RuntimeError(f"fig 9 {name}: committed {s['committed']} "
                               f"of {s['n_requests']}")
        out[name] = {k: s[k] for k in (
            "n_requests", "committed", "fast_commit_ratio", "median_latency",
            "p90_latency", "throughput", "events", "messages")}
        out[name]["wall_s"] = wall
        out[name]["wall_per_sim_s"] = wall / (FIG9_DURATION + work.drain)
    return out


# Phase 14: training on the card (`repro_torch.train`, `launch/train.py`).
# tinyllama-1.1b and mamba2-130m at full width, random from seed 0, on the
# reference's packed synthetic tokens, with the reference's step defaults
# (remat "full", AdamW, float32 master weights and moments, bf16 compute).
TRAIN_ARCHS = {"tinyllama-1.1b": "flash_attention", "mamba2-130m": "ssd_scan"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_MICRO = 8, 2048, 4, 2
C1_SEQ = 512              # the C1 gate's model step: B 1 x S 512
C1_SEED = 14              # its tokens
# The C1 model gate's limits sit between what it reads on sound kernels
# and on kernels made wrong on purpose (`scripts/c1_gate_readings.py`, an
# H100, token seeds 14-16): float32, relative L2 a leaf, sound <= 9.8e-4
# (mamba2's A_log), wrong >= 0.14; bf16, a leaf's kernels-vs-plain gap
# over the plain version's own bf16-vs-float32 gap, sound <= 1.07, wrong
# 2.0-26 (a lost state handoff reads 1.09 there: mamba2's bf16 gradients
# are noise on random weights, and the float32 limit holds the scan).
C1_REL_L2 = 1e-2
C1_BF16_X = 1.5
C1_NONZERO = {"tinyllama-1.1b": (("attn", "wq"), ("attn", "wk"),
                                 ("attn", "wv")),
              "mamba2-130m": (("mamba", "in_proj"),)}


def kernel_modules() -> dict:
    from repro_torch.kernels import dom_admit as admit_mod
    from repro_torch.kernels import dom_release as release_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import inchash as inchash_mod
    from repro_torch.kernels import ssd_scan as ssd

    return {"flash_attention": fa, "ssd_scan": ssd, "dom_admit": admit_mod,
            "dom_release": release_mod, "inchash": inchash_mod}


def reset_counts() -> None:
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    mods["flash_attention"].launches_tensor_core = 0
    mods["flash_attention"].launches_scalar = 0


def read_counts() -> dict:
    mods = kernel_modules()
    out = {k: m.launches for k, m in mods.items()}
    out["flash_attention_tensor_core"] = \
        mods["flash_attention"].launches_tensor_core
    return out


@contextlib.contextmanager
def plain_kernels(names):
    """The named kernels' CUDA wrappers swapped for their plain versions
    (as phases 6, 8 and 12 swap them)."""
    mods = kernel_modules()
    saved = {k: getattr(mods[k], f"{k}_cuda") for k in names}
    for k in names:
        setattr(mods[k], f"{k}_cuda", getattr(mods[k], f"{k}_plain"))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(mods[k], f"{k}_cuda", fn)


def c1_op_gradients(dev) -> dict:
    """Phase 14 (c), op level: each kernel's autograd Function against
    autograd of its plain version at phase 5's shape (flash_attention, B 2,
    S 4096, 32/4 heads of 64, causal, bf16) and phase 7's (ssd_scan, b 2,
    S 4096, H 24, P 64, N 128, x/B/C bf16, dt float32, both outputs
    weighted; phase 7's input distribution): the gradients must be equal,
    exactly (the backward is the plain version's); the forwards within
    phase 5's tolerance (absolute) and phase 7's (|got - want| <= tol +
    tol |want|)."""
    import torch

    mods = kernel_modules()
    fa, ssd = mods["flash_attention"], mods["ssd_scan"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def grads(fn, inputs, weights):
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
        g = torch.autograd.grad(loss, leaves)
        return outs[0].detach(), g

    cases = {
        "flash_attention": (
            lambda *a: fa.flash_attention_autograd(*a, causal=True),
            lambda *a: fa.flash_attention_plain(*a, causal=True),
            (rnd(2, 4096, 32, 64), rnd(2, 4096, 4, 64), rnd(2, 4096, 4, 64)),
            (rnd(2, 4096, 32, 64, dtype=torch.float32),), FA_TOL["bfloat16"],
            0.0),
        "ssd_scan": (
            lambda *a: ssd.ssd_scan_autograd(*a, chunk=128),
            lambda *a: ssd.ssd_scan_plain(*a, chunk=128),
            (rnd(2, 4096, 24, 64),
             rnd(2, 4096, 24, dtype=torch.float32).abs() * 0.3 + 0.01,
             -rnd(24, dtype=torch.float32).abs() - 0.1,
             rnd(2, 4096, 128), rnd(2, 4096, 128)),
            (rnd(2, 4096, 24, 64, dtype=torch.float32),
             rnd(2, 24, 128, 64, dtype=torch.float32)), SSD_TOL["bfloat16"],
            SSD_TOL["bfloat16"]),
    }
    out = {}
    for name, (kern, plain, inputs, weights, tol, rel) in cases.items():
        reset_counts()
        y_k, g_k = grads(kern, inputs, weights)
        launched = read_counts()[name]
        y_p, g_p = grads(plain, inputs, weights)
        torch.cuda.synchronize()
        diff = (y_k.float() - y_p.float()).abs()
        err = float(diff.max().cpu())
        excess = float((diff - rel * y_p.float().abs()).max().cpu())
        exact = all(a.dtype == b.dtype and bool(torch.equal(a, b))
                    for a, b in zip(g_k, g_p))
        out[name] = {"forward_max_abs_err": err, "grads_equal": exact,
                     "launches": launched, "tol": tol, "rel_tol": rel}
        if not (exact and excess <= tol and launched == 1):
            raise RuntimeError(f"C1 op gate, {name}: {out[name]}")
        del y_k, g_k, y_p, g_p
    torch.cuda.empty_cache()
    return out


def _leaves_by_path(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_by_path(v, path + (k,)))
        return out
    return {path: tree}


def _rel_l2(got: dict, want: dict) -> dict:
    """Relative L2 difference of each leaf of ``got`` from ``want``."""
    import torch

    return {"/".join(p): float((torch.linalg.vector_norm(
        (got[p] - want[p]).float()) / torch.linalg.vector_norm(
        want[p].float()).clamp_min(1e-30)).cpu()) for p in want}


def c1_gradients(dev, name: str) -> dict:
    """One step's gradients of ``name`` at full width (B 1 x S C1_SEQ,
    tokens from C1_SEED, parameters from seed 0, remat "full") through the
    kernels and through their plain versions, in float32 and in bf16
    compute. Returns, a leaf each, the relative L2 differences: kernels
    vs plain in float32 (``float32``) and in bf16 (``bf16``), and the
    plain version's own bf16 noise, plain bf16 vs plain float32
    (``witness``); beside them each run's launch counts, and whether the
    kernels' gradients are finite and the attention's wq/wk/wv (the
    mixer's in_proj) nonzero in every layer."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, make_loss_fn
    from repro_torch.train.optimizer import tree_map

    cfg = get_config(name)
    kernel = TRAIN_ARCHS[name]
    params = init_params(cfg, seed=0, device=dev)
    tokens = np.random.default_rng(C1_SEED).integers(0, cfg.vocab,
                                                     (1, C1_SEQ))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}

    def grads() -> dict:
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = make_loss_fn(cfg)(leaves, batch)
        flat = _leaves_by_path(leaves)
        got = torch.autograd.grad(loss, list(flat.values()))
        return dict(zip(flat, got))

    out = {"launches": {}, "nonzero_every_layer": True, "finite": True}
    plain32 = None
    for dtype in ("float32", "bfloat16"):
        with compute_dtype(dtype):
            reset_counts()
            g_kern = grads()
            torch.cuda.synchronize()
            out["launches"][dtype] = read_counts()
            with plain_kernels((kernel,)):
                g_plain = grads()
        out["leaves"] = len(g_kern)
        out["nonzero_every_layer"] &= all(
            bool((g_kern[("layers",) + leaf].flatten(1) != 0).any(1).all()
                 .cpu()) for leaf in C1_NONZERO[name])
        out["finite"] &= all(bool(torch.isfinite(g).all().cpu())
                             for g in g_kern.values())
        if dtype == "float32":
            out["float32"] = _rel_l2(g_kern, g_plain)
            plain32 = g_plain
        else:
            out["bf16"] = _rel_l2(g_kern, g_plain)
            out["witness"] = _rel_l2(g_plain, plain32)
        del g_kern, g_plain
    del params, plain32
    torch.cuda.empty_cache()
    return out


def c1_model_gate(dev, name: str) -> dict:
    """Phase 14 (c), model level (`c1_gradients`): every leaf has a
    gradient, finite, the attention's wq/wk/wv (the mixer's in_proj)
    nonzero in every layer, the kernel launched once a layer in the
    forward and once in the recompute (in bf16 on tinyllama's tensor
    cores); in float32 the kernels' gradients within C1_REL_L2 (relative
    L2) of the plain versions' in every leaf, and in bf16 within
    C1_BF16_X times the plain version's own bf16 noise in every leaf."""
    from repro_torch.configs import get_config

    r = c1_gradients(dev, name)
    kernel = TRAIN_ARCHS[name]
    want = 2 * get_config(name).n_layers
    ratio = {k: r["bf16"][k] / max(r["witness"][k], 1e-30) for k in r["bf16"]}
    f32_leaf = max(r["float32"], key=r["float32"].get)
    bf16_leaf = max(ratio, key=ratio.get)
    out = {"leaves": r["leaves"], "launches": want,
           "float32_max_rel_l2": r["float32"][f32_leaf],
           "float32_leaf": f32_leaf, "bf16_max_ratio": ratio[bf16_leaf],
           "bf16_leaf": bf16_leaf, "bf16_rel_l2": r["bf16"][bf16_leaf],
           "bf16_witness": r["witness"][bf16_leaf],
           "bf16_max_rel_l2": max(r["bf16"].values())}
    launched = [r["launches"][d][kernel] for d in r["launches"]]
    if kernel == "flash_attention":
        launched.append(r["launches"]["bfloat16"][
            "flash_attention_tensor_core"])
    if not (launched == [want] * len(launched) and r["finite"]
            and r["nonzero_every_layer"]
            and out["float32_max_rel_l2"] <= C1_REL_L2
            and out["bf16_max_ratio"] <= C1_BF16_X):
        raise RuntimeError(f"C1 model gate, {name}: {out}, launches "
                           f"{r['launches']}, finite {r['finite']}, nonzero "
                           f"{r['nonzero_every_layer']}")
    return out


def drive_train(dev, name: str) -> dict:
    """Phase 14 (a, b): TRAIN_STEPS `make_train_step(microbatches=2)`
    steps of ``name`` at full width on B 8 x S 2048 packed synthetic
    tokens (`repro_torch.data`, seed 0), with every launch count reset just
    before each step and read just after: the kernel once a layer and
    microbatch in the forward and once in its recompute, nothing else."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.train.train_step import make_train_state, make_train_step

    cfg = get_config(name)
    kernel = TRAIN_ARCHS[name]
    want = {k: 0 for k in kernel_modules()}
    want[kernel] = cfg.n_layers * TRAIN_MICRO * 2
    if kernel == "flash_attention":
        want["flash_attention_tensor_core"] = want[kernel]
    else:
        want["flash_attention_tensor_core"] = 0
    data = SyntheticTokenDataset(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, microbatches=TRAIN_MICRO)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "step_s": [], "loss": [],
           "grad_norm": [], "lr": [], "launches": []}
    for i in range(TRAIN_STEPS):
        batch = {"tokens": torch.as_tensor(data.batch_at(i)["tokens"],
                                           device=dev)}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        vals = torch.stack([metrics["loss"], metrics["grad_norm"],
                            metrics["lr"]]).cpu().numpy()
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append(read_counts())
        for key, v in zip(("loss", "grad_norm", "lr"), vals):
            out[key].append(float(v))
        if out["launches"][-1] != want:
            raise RuntimeError(f"{name} train step {i} launched "
                               f"{out['launches'][-1]}, not {want}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["want"] = want
    out["params"] = sum(p.numel() for p in _leaves_by_path(
        state.params).values())
    if not (np.isfinite(out["loss"]).all()
            and np.isfinite(out["grad_norm"]).all()
            and all(bool(torch.isfinite(p).all().cpu())
                    for p in _leaves_by_path(state.params).values())):
        raise RuntimeError(f"{name} training is not finite: {out}")
    del state, step
    torch.cuda.empty_cache()
    return out


def train_line(name: str, r: dict) -> str:
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm = sorted(r["step_s"][1:])
    med = warm[len(warm) // 2]
    return (f"{name} training ({r['params']} parameters, B {TRAIN_BATCH} x "
            f"S {TRAIN_SEQ}, microbatches {TRAIN_MICRO}, remat full; init "
            f"{r['init_s']:.2f} s): step s "
            f"{json.dumps([round(s, 4) for s in r['step_s']])} (median of "
            f"steps 2-{TRAIN_STEPS} {med:.4f} s, {tokens / med:.0f} tokens/s), "
            f"peak {r['peak_gb']:.2f} GB, loss "
            f"{json.dumps([round(x, 4) for x in r['loss']])}, grad norm "
            f"{json.dumps([round(x, 4) for x in r['grad_norm']])}, launches a "
            f"step {json.dumps(r['launches'][-1])}")


def drive_drill(dev) -> dict:
    """Phase 14 (d): `examples/train_100m_torch.py`'s kill-and-restore
    drill at its defaults on the card, the launch counts reset just before
    and read just after; its checkpoints are removed afterwards."""
    import importlib.util
    import shutil

    import torch

    path = Path(__file__).resolve().parent / "examples" / \
        "train_100m_torch.py"
    spec = importlib.util.spec_from_file_location("train_100m_torch", path)
    drill = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drill)
    reset_counts()
    t0 = time.perf_counter()
    try:
        r = drill.run_drill(device=str(dev), quiet=True)
    finally:
        shutil.rmtree(drill.DEFAULT_CKPT, ignore_errors=True)
    torch.cuda.synchronize()
    r["wall_s"] = time.perf_counter() - t0
    r["launches"] = read_counts()
    cfg = drill.config_100m()
    want = 200 * cfg.n_layers * 2 * 2   # steps x layers x microbatches x 2
    if r["launches"]["flash_attention"] != want:
        raise RuntimeError(f"the drill launched {r['launches']}, not "
                           f"{want} flash_attention")
    torch.cuda.empty_cache()
    return r


def drive_training(dev) -> dict:
    """Phase 14: C1's op gate, the two full-width train runs, C1's model
    gate, the drill; returns their results and prints a line each."""
    t_phase = time.perf_counter()
    out = {"c1_ops": c1_op_gradients(dev)}
    for name, r in out["c1_ops"].items():
        print(f"C1 op gate, {name} (phase {5 if name == 'flash_attention' else 7}"
              f"'s shape, bf16): gradients through the autograd Function == "
              f"autograd of the plain version, exactly; forward max abs err "
              f"{r['forward_max_abs_err']:.3g} (tolerance {r['tol']} + "
              f"{r['rel_tol']} |want|); "
              f"{r['launches']} launch")
    out["train"] = {}
    for name in TRAIN_ARCHS:
        out["train"][name] = drive_train(dev, name)
        print(train_line(name, out["train"][name]))
    out["c1_model"] = {}
    for name in TRAIN_ARCHS:
        r = out["c1_model"][name] = c1_model_gate(dev, name)
        print(f"C1 model gate, {name} (B 1 x S {C1_SEQ}, kernels vs plain "
              f"versions, {r['leaves']} leaves, every one with a gradient, "
              f"{'/'.join(x[-1] for x in C1_NONZERO[name])} nonzero in every "
              f"layer, {r['launches']} launches a run): float32 max relative "
              f"L2 {r['float32_max_rel_l2']:.3g} ({r['float32_leaf']}; the "
              f"gate {C1_REL_L2}); bf16 at most {r['bf16_max_ratio']:.3g} "
              f"times the plain version's own bf16 noise ({r['bf16_leaf']}: "
              f"{r['bf16_rel_l2']:.3g} vs plain bf16 against plain float32 "
              f"{r['bf16_witness']:.3g}; the gate {C1_BF16_X}x), bf16 max "
              f"relative L2 {r['bf16_max_rel_l2']:.3g}")
    d = out["drill"] = drive_drill(dev)
    print(f"train_100m_torch drill ({d['params']} parameters, 200 steps of "
          f"8 x 256, microbatches 2, checkpoints every 50 through the "
          f"replicated log): restored at step {d['restored_at']} (log "
          f"{json.dumps(d['log_committed'])}), every leaf bit for bit; loss "
          f"{d['losses'][0]:.4f} -> {d['losses'][-1]:.4f}; steps 1-100 "
          f"{d['first_half_s']:.2f} s, restore {d['restore_s']:.2f} s, steps "
          f"101-200 {d['second_half_s']:.2f} s; flash_attention launches "
          f"{d['launches']['flash_attention']}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 14 wall {out['wall_s']:.1f} s")
    return out


def training_record(training: dict, kernel: str) -> dict:
    """Phase 14's launch counts of ``kernel`` for the kernels' record: a
    train step of the model that runs it, the C1 gates, the drill."""
    name = next(n for n, k in TRAIN_ARCHS.items() if k == kernel)
    out = {"model": name,
           "launches_per_step": training["train"][name]["launches"][-1][
               kernel],
           "c1_op": training["c1_ops"][kernel],
           "c1_model_float32_max_rel_l2": training["c1_model"][name][
               "float32_max_rel_l2"],
           "c1_model_bf16_max_ratio": training["c1_model"][name][
               "bf16_max_ratio"]}
    if kernel == "flash_attention":
        out["drill_launches"] = training["drill"]["launches"][kernel]
    return out


def profile_train_step(dev) -> None:
    """`--profile`: one tinyllama-1.1b train step (phase 14's) under
    torch.profiler after a warm one: device time by kernel, busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.train.train_step import make_train_state, make_train_step

    cfg = get_config("tinyllama-1.1b")
    data = SyntheticTokenDataset(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0))
    state = make_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, microbatches=TRAIN_MICRO)
    batch = {"tokens": torch.as_tensor(data.batch_at(0)["tokens"],
                                       device=dev)}
    state, _ = step(state, batch)                     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled tinyllama-1.1b train step (B {TRAIN_BATCH} x S "
          f"{TRAIN_SEQ}, microbatches {TRAIN_MICRO}): wall {wall * 1e3:.2f} "
          f"ms (profiler on), device kernels {busy_us / 1e3:.2f} ms, busy "
          f"share {busy_us / 1e6 / wall:.3f}")
    print(events.table(sort_by="self_device_time_total", row_limit=20))
    del state, step
    torch.cuda.empty_cache()


# Phase 15: C4 (flash_attention at head dims 16 and 32), the one-shot DOM
# primitives, Figs 1-3, the runtime sanitizer and the example ports.
# The reference's kernel-test shapes (tests/test_kernels.py:30-34), B 2,
# S = Sk: (S, Hq, Hk, D, causal, window)
SMALL_HEAD_SHAPES = ((128, 4, 2, 16, True, None), (96, 4, 1, 32, True, None),
                     (128, 2, 2, 16, False, None),
                     (256, 4, 2, 16, True, 64), (64, 8, 8, 64, True, None))
ONE_SHOT_SIZES = (10_000, 100_000, 1_000_000)
ONE_SHOT_CALLS = ("dom_release_schedule_watermark", "nezha_commit_times",
                  "classify_commits")
FIG_N_MSGS = 100_000            # benchmarks/figs.py, quick=False
# The examples phase 15 starts as subprocesses, with where each runs
EXAMPLES = {"replicated_serving_torch.py": "on the card",
            "fair_exchange_torch.py": "host only"}


def check_small_heads(dev) -> list:
    """C4: flash_attention at the reference's kernel-test shapes in both
    types against its plain version, timed beside SDPA and the bound; one
    more call each, with the route counters read around it, shows which
    kernel launched (D 16 and 32 the scalar one in either type)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    rows = []
    for S, Hq, Hk, D, causal, window in SMALL_HEAD_SHAPES:
        for dtype in ("bfloat16", "float32"):
            r = check_attention(dev, 2, S, S, Hq, Hk, D, dtype, causal,
                                window, timed=True)
            q, k, v = attention_inputs(dev, 2, S, S, Hq, Hk, D,
                                       getattr(torch, dtype))
            before = (fa.launches_tensor_core, fa.launches_scalar)
            fa.flash_attention(q, k, v, causal=causal, window=window)
            launched = ("tensor_core" if fa.launches_tensor_core > before[0]
                        else "scalar" if fa.launches_scalar > before[1]
                        else None)
            want = ("tensor_core" if dtype == "bfloat16" and D >= 64
                    else "scalar")
            if not r["route"] == launched == want:
                raise RuntimeError(f"flash_attention at {r['shape']}: route "
                                   f"{r['route']}, launched {launched}, "
                                   f"want {want}")
            rows.append(r)
    return rows


def one_shot_batch(n: int, seed: int = 0):
    """Phase 3's realistic batch at R 3 with replica 2 dead (it receives
    and replies nothing), lognormal reply delays and 1024 key classes."""
    import numpy as np

    d, a = realistic_batch(n, 3, seed)
    rng = np.random.default_rng(seed + 1)
    a[:, 2] = np.inf
    reply = rng.lognormal(np.log(50e-6), 0.5, (n, 3))
    reply[:, 2] = np.inf
    return d, a, reply, rng.integers(0, 1024, n)


def drive_one_shot() -> dict:
    """Phase 15 (b): the watermark schedule, `nezha_commit_times` and
    `classify_commits` (its own deadline order, a capped mask) on the card
    against the CPU, bit for bit, each call with the DOM counts reset just
    before and read just after (the schedule one `dom_admit` launch, the
    commit times one of each kernel, the classification one `dom_release`
    launch); the exact oracle at n 512."""
    import numpy as np

    from repro_torch.core import vectorized as vec
    from repro_torch.core.engine import classify_commits

    rows = []
    for n in ONE_SHOT_SIZES:
        d, a, reply, keys = one_shot_batch(n)
        admitted, release = vec.dom_release_schedule_watermark(
            d, a, device="cpu")
        slow = np.random.default_rng(n).random(n) < 0.2
        calls = {
            "dom_release_schedule_watermark": (
                lambda dev: vec.dom_release_schedule_watermark(
                    d, a, device=dev), {"dom_admit": 1, "dom_release": 0}),
            "nezha_commit_times": (
                lambda dev: vec.nezha_commit_times(
                    d, a, reply, 0, 1, key_ids=keys, device=dev),
                {"dom_admit": 1, "dom_release": 1}),
            "classify_commits": (
                lambda dev: classify_commits(
                    d, a, admitted, release, reply, 0, 1, key_ids=keys,
                    force_slow=slow, device=dev),
                {"dom_admit": 0, "dom_release": 1})}
        row = {"n": n}
        for name, (call, want) in calls.items():
            call("cuda")                                # warm
            reset_dom_counts()
            t0 = time.perf_counter()
            card = call("cuda")                         # numpy: synced
            card_s = time.perf_counter() - t0
            counts = dom_counts()
            t0 = time.perf_counter()
            cpu = call("cpu")
            cpu_s = time.perf_counter() - t0
            diff = first_difference(card, cpu, name)
            if diff is not None:
                raise RuntimeError(f"{name} at n {n}: the card and the CPU "
                                   f"differ at {diff}")
            got = {k: sum(v.values()) for k, v in counts.items()}
            if got != want:
                raise RuntimeError(f"{name} at n {n}: launches {got}, want "
                                   f"{want}")
            row[name] = {"card_s": card_s, "cpu_s": cpu_s,
                         "launches_by_route": counts}
            if name == "nezha_commit_times":
                row["committed"] = int(card["committed"].sum())
                row["fast"] = int(card["fast"].sum())
        rows.append(row)
    d, a, *_ = one_shot_batch(512, seed=3)
    reset_dom_counts()
    exact = vec.dom_release_schedule(d, a, device="cuda")
    if any(sum(v.values()) for v in dom_counts().values()):
        raise RuntimeError("the exact oracle launched a kernel")
    for label, other in (
            ("the watermark schedule", vec.dom_release_schedule_watermark(
                d, a, device="cuda")),
            ("the CPU", vec.dom_release_schedule(d, a, device="cpu"))):
        diff = first_difference(exact, other, "schedule")
        if diff is not None:
            raise RuntimeError(f"the exact oracle at n 512 differs from "
                               f"{label} at {diff}")
    return {"rows": rows}


def drive_figs() -> dict:
    """Phase 15 (c): Figs 1-3 at `benchmarks/figs.py`'s full settings
    (n_msgs 1e5), the port's network and metrics; Fig 3's DOM admission on
    the card (`dom_admit`, onesweep route at n 1e5, R 2) equal to the
    CPU's, with the counts read around each call."""
    import numpy as np

    from repro_torch.core.vectorized import dom_reordering, multicast_reordering
    from repro_torch.sim.network import CloudNetwork, NetworkParams

    n_msgs = FIG_N_MSGS
    out = {"fig1": [], "fig2": [], "fig3": []}
    for rate in (1e3, 2e3, 5e3, 10e3, 20e3, 50e3):
        net = CloudNetwork(4, NetworkParams(), seed=1)
        sends = np.sort(np.random.default_rng(0).uniform(
            0, n_msgs / (2 * rate), n_msgs))
        srcs = np.random.default_rng(1).integers(0, 2, n_msgs) + 2
        owd, _ = net.sample_owd_matrix(srcs, n_msgs, [0, 1])
        out["fig1"].append({"rate": rate, "reordering_pct":
                            multicast_reordering(owd, sends)})
    for n_send in (1, 2, 5, 10, 20):
        net = CloudNetwork(2 + n_send, NetworkParams(), seed=2)
        dur = n_msgs / (n_send * 10_000)
        sends = np.sort(np.random.default_rng(3).uniform(0, dur, n_msgs))
        srcs = np.random.default_rng(4).integers(0, n_send, n_msgs) + 2
        owd, _ = net.sample_owd_matrix(srcs, n_msgs, [0, 1])
        out["fig2"].append({"n_senders": n_send, "reordering_pct":
                            multicast_reordering(owd, sends)})
    n_send = 10
    net = CloudNetwork(2 + n_send, NetworkParams(), seed=5)
    rng = np.random.default_rng(6)
    sends = np.sort(rng.uniform(0, n_msgs / (n_send * 10_000), n_msgs))
    srcs = rng.integers(0, n_send, n_msgs) + 2
    owd, _ = net.sample_owd_matrix(srcs, n_msgs, [0, 1])
    out["fig3"].append({"percentile": 0, "reordering_pct":
                        multicast_reordering(owd, sends)})
    for pctl in (50, 75, 90, 95):
        deadlines = sends + (np.percentile(owd, pctl) + 3 * 60e-9)
        reset_dom_counts()
        t0 = time.perf_counter()
        card = dom_reordering(owd, sends, deadlines, device="cuda")
        card_s = time.perf_counter() - t0
        counts = dom_counts()
        t0 = time.perf_counter()
        cpu = dom_reordering(owd, sends, deadlines, device="cpu")
        cpu_s = time.perf_counter() - t0
        if card != cpu or counts["dom_admit"] != {"small": 0, "onesweep": 1}:
            raise RuntimeError(f"Fig 3 p{pctl}: card {card}, CPU {cpu}, "
                               f"launches {json.dumps(counts)}")
        hold = np.maximum(deadlines[:, None] - (sends[:, None] + owd),
                          0.0).mean()
        out["fig3"].append({"percentile": pctl, "reordering_pct": card,
                            "hold_us": hold * 1e6, "card_s": card_s,
                            "cpu_s": cpu_s, "launches_by_route": counts})
    return out


@contextlib.contextmanager
def sanitizer_probe():
    """Every `Sanitizer` that checked an epoch inside the block."""
    from repro_torch.core.sanitizer import Sanitizer

    seen = []
    check = Sanitizer.check_epoch

    def probed(self, s, eng):
        check(self, s, eng)
        if not any(x is self for x in seen):
            seen.append(self)

    Sanitizer.check_epoch = probed
    try:
        yield seen
    finally:
        Sanitizer.check_epoch = check


def sanitizer_totals(seen: list) -> tuple[int, list]:
    return (sum(x.epochs_checked for x in seen),
            [v for x in seen for v in x.violations])


def drive_sanitized(rate: float, duration: float, main_run, scen: dict,
                    shard: dict) -> dict:
    """Phase 15 (d): phase 4's deployment, the 28 scenarios and
    `nezha-sharded` at G 16 batched, each with the runtime sanitizer on:
    bit for bit its unsanitized card run of phases 4, 10 and 11, every
    epoch with requests checked, no violation."""
    import dataclasses

    from repro_torch.sim.scenario import get_scenario

    gpu_cl, gpu_sum, gpu_s = main_run
    with sanitizer_probe() as seen:
        cl, summ, wall = drive_main_path("cuda", rate, duration,
                                         sanitize=True)
    checked, bad = sanitizer_totals(seen)
    diff = main_path_difference(gpu_cl, gpu_sum, cl, summ)
    if diff is not None or bad or checked != summ["batches"] \
            or seen != [cl.engine.sanitizer]:
        raise RuntimeError(f"the sanitized main path: difference {diff}, "
                           f"{checked} epochs checked of {summ['batches']}, "
                           f"violations {bad[:3]}")
    out = {"main_path": {"wall_s": wall, "unsanitized_wall_s": gpu_s,
                         "epochs_checked": checked}}
    print(f"phase 4's deployment sanitized on the card: {checked} epochs "
          f"checked (= epochs with requests), no violation; bit for bit "
          f"the unsanitized card run; wall {wall:.3f} s (unsanitized, phase "
          f"4: {gpu_s:.3f} s)")
    t0 = time.perf_counter()
    total, walls = 0, {}
    for name, card in scen["card_runs"].items():
        sc = get_scenario(name)
        sc = dataclasses.replace(sc, overrides={**sc.overrides,
                                                "sanitize": True})
        with sanitizer_probe() as seen:
            run = run_scenario_traced(sc, "cuda")
        checked, bad = sanitizer_totals(seen)
        same_runs(card, run, "the sanitized and the unsanitized card runs")
        if bad or checked != run["dispatches"]:
            raise RuntimeError(f"{name} sanitized: {checked} epochs checked "
                               f"of {run['dispatches']}, violations "
                               f"{bad[:3]}")
        total += checked
        walls[name] = {"sanitized_s": run["wall"], "unsanitized_s":
                       card["wall"]}
    out["scenarios"] = {"epochs_checked": total, "walls": walls,
                        "wall_s": time.perf_counter() - t0}
    print(f"the {len(walls)} scenarios sanitized on the card: {total} epochs "
          f"checked, no violation, each bit for bit its phase-10 card run; "
          f"walls sanitized {sum(w['sanitized_s'] for w in walls.values()):.3f}"
          f" s, unsanitized {sum(w['unsanitized_s'] for w in walls.values()):.3f} s")
    with sanitizer_probe() as seen:
        r = run_deployment("nezha-sharded", 16, "cuda", True,
                           sharded_workload(), sanitize=True)
    checked, bad = sanitizer_totals(seen)
    want = shard["runs"][16]["batched"]
    diff = first_difference(want["summary"], r["summary"], "summary") or \
        first_difference(shard["g16_state"], sharded_state(r["cluster"]))
    if diff is not None or bad or checked <= 0 or len(seen) != 16:
        raise RuntimeError(f"nezha-sharded G 16 batched sanitized: "
                           f"difference {diff}, {checked} epochs checked by "
                           f"{len(seen)} groups, violations {bad[:3]}")
    out["sharded_g16"] = {"epochs_checked": checked,
                          "timed_s": r["timed_s"],
                          "unsanitized_timed_s": want["timed_s"]}
    print(f"nezha-sharded G 16 batched sanitized on the card: {checked} "
          f"group epochs checked, no violation, bit for bit phase 11's "
          f"batched run; timed wall {r['timed_s']:.3f} s (unsanitized "
          f"{want['timed_s']:.3f} s)")
    return out


def quickstart_in_process(root: Path) -> dict:
    """Phase 15 (e), in this process: `quickstart_torch.main()` once on
    the card, with the flash_attention counts reset just before and read
    just after its two demos that C4 opened -- the training demo (smoke
    tinyllama, head dim 16: 8 steps x 2 layers x the forward and its remat
    recompute) and the kernel demo (D 32); every launch must take the
    scalar kernel. Its printed lines go to a buffer."""
    from repro_torch.kernels import flash_attention as fa

    sys.path.insert(0, str(root / "examples"))
    import quickstart_torch

    out = {}

    def counted(name, call):
        def run(*args, **kw):
            fa.launches = fa.launches_tensor_core = fa.launches_scalar = 0
            t0 = time.perf_counter()
            value = call(*args, **kw)
            counts = {"launches": fa.launches,
                      "tensor_core": fa.launches_tensor_core,
                      "scalar": fa.launches_scalar}
            out[name] = dict(counts, wall_s=time.perf_counter() - t0)
            return value
        return run

    demos = {"quickstart training": "demo_training",
             "quickstart kernel": "demo_kernel"}
    plain = {attr: getattr(quickstart_torch, attr) for attr in demos.values()}
    for name, attr in demos.items():
        setattr(quickstart_torch, attr, counted(name, plain[attr]))
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            quickstart_torch.main()
    finally:
        for attr, call in plain.items():
            setattr(quickstart_torch, attr, call)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    if lines[-1] != "quickstart OK":
        raise RuntimeError(f"quickstart_torch.main() ended with {lines[-1]!r}")
    for name in demos:
        counts = {k: out[name][k] for k in ("launches", "tensor_core",
                                            "scalar")}
        if counts["launches"] <= 0 or counts["scalar"] != counts["launches"]:
            raise RuntimeError(f"{name}: flash_attention launches "
                               f"{json.dumps(counts)}, want all scalar")
    print(f"  examples/quickstart_torch.py (in process, on the card): "
          f"{len(lines)} lines, wall {wall:.1f} s; last: {lines[-1]}")
    for name in demos:
        print(f"    {name}: flash_attention "
              f"{json.dumps({k: v for k, v in out[name].items() if k != 'wall_s'})}"
              f", wall {out[name]['wall_s']:.2f} s")
    return out


def drive_examples(root: Path) -> dict:
    """Phase 15 (e): the serving and exchange ports as subprocesses at
    their default device, both at once, while the quickstart runs in this
    process; each must exit 0. The exchange runs on the host (its
    event-driven backend has no device; it only checks ``--device``).
    Their output is small, read when each has ended."""
    import os

    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(root / "examples" / name)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in EXAMPLES}
    ended = {}
    try:
        quickstart = quickstart_in_process(root)
        while len(ended) < len(procs):
            for name, proc in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 600:
                raise RuntimeError(f"examples still running after 600 s: "
                                   f"{sorted(set(procs) - set(ended))}")
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for name, proc in procs.items():
        lines = proc.communicate()[0].strip().splitlines()
        out[name] = {"rc": proc.returncode, "wall_s": ended[name],
                     "last": lines[-1] if lines else ""}
        if proc.returncode != 0:
            raise RuntimeError(f"examples/{name} exited {proc.returncode}:\n"
                               + "\n".join(lines[-20:]))
        print(f"  examples/{name} (subprocess, {EXAMPLES[name]}): exit 0, "
              f"{len(lines)} lines, wall {ended[name]:.1f} s; last: "
              f"{out[name]['last']}")
    return {"quickstart": quickstart, "subprocesses": out}


def drive_phase15(dev, root: Path, rate: float, duration: float, main_run,
                  scen: dict, shard: dict) -> dict:
    t_phase = time.perf_counter()
    print("flash_attention at head dims 16 and 32 (C4; the reference's "
          "kernel-test shapes, B 2, kernel vs plain on the card):")
    heads = check_small_heads(dev)
    for r in heads:
        print(f"  {r['shape']}: err {r['max_abs_err']:.3g}, "
              f"{attention_line(r)}")
    print("one-shot DOM primitives (R 3, replica 2 dead; card == CPU, bit "
          "for bit):")
    one = drive_one_shot()
    for row in one["rows"]:
        for name in ONE_SHOT_CALLS:
            x = row[name]
            print(f"  n {row['n']}: {name}: card {x['card_s'] * 1e3:.2f} ms, "
                  f"CPU {x['cpu_s'] * 1e3:.2f} ms, launches dom_admit "
                  f"{json.dumps(x['launches_by_route']['dom_admit'])} "
                  f"dom_release "
                  f"{json.dumps(x['launches_by_route']['dom_release'])}")
        print(f"  n {row['n']}: {row['committed']} committed, {row['fast']} "
              f"fast")
    print("  n 512: the exact oracle (dom_release_schedule) on the card == "
          "the watermark schedule == the CPU, no launch")
    figs = drive_figs()
    print("Figs 1-3 (benchmarks/figs.py, n_msgs 1e5): "
          + "; ".join(f"fig 1 rate {r['rate']:.0f}/s {r['reordering_pct']:.2f}%"
                      for r in figs["fig1"]))
    print("  " + "; ".join(f"fig 2 senders {r['n_senders']} "
                           f"{r['reordering_pct']:.2f}%" for r in figs["fig2"]))
    print("  " + "; ".join(
        f"fig 3 p{r['percentile']} {r['reordering_pct']:.3f}%"
        + (f" (hold {r['hold_us']:.1f} us, card {r['card_s'] * 1e3:.1f} ms,"
           f" CPU {r['cpu_s'] * 1e3:.1f} ms)" if r["percentile"] else "")
        for r in figs["fig3"]) + "; card == CPU, one onesweep dom_admit "
        "launch a point")
    sanitized = drive_sanitized(rate, duration, main_run, scen, shard)
    print("the example ports (the quickstart and serving on the card, the "
          "exchange on the host):")
    examples = drive_examples(root)
    wall = time.perf_counter() - t_phase
    print(f"phase 15 wall {wall:.1f} s")
    return {"small_heads": heads, "one_shot": one, "figs": figs,
            "sanitized": sanitized,
            "small_head_paths": examples["quickstart"],
            "examples": examples["subprocesses"], "wall_s": wall}


# Phase 16: the cells `run_cell` drives at one chip's batch of the 16x16
# mesh, and the flash_attention launches each must make in one step
# (tinyllama-1.1b: 22 layers; train: the forward and its recompute in each
# microbatch)
P16_CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"),
             ("tinyllama-1.1b", "decode_32k"), ("tinyllama-1.1b", "long_500k"),
             ("mamba2-130m", "long_500k"))
P16_CALLS = 1            # timed calls after the warm one, per run
# the hillclimb's runs cut to 4 layers (hymba-1.5b's chunk-32 train step
# takes 12-18 s at its 32): the phase's time, not the cells', is cut
P16_HILLCLIMB_LAYERS = 4


@contextlib.contextmanager
def ssd_chunk_probe():
    """Counts `ssd_scan_cuda` calls on the card by their chunk while
    active (not the abstract pass's recorded ones, on fake CPU tensors)."""
    from collections import Counter

    from repro_torch.kernels import ssd_scan as ssd

    seen: Counter = Counter()
    real = ssd.ssd_scan_cuda

    def probe(x, *args, chunk: int = 128, **kw):
        if x.device.type == "cuda":
            seen[chunk] += 1
        return real(x, *args, chunk=chunk, **kw)

    ssd.ssd_scan_cuda = probe
    try:
        yield seen
    finally:
        ssd.ssd_scan_cuda = real


def _same_bits(placed, params, path=()) -> int:
    """Every DTensor leaf of ``placed`` holds ``params``' leaf bit for bit;
    returns the leaves compared."""
    import torch

    if isinstance(params, dict):
        return sum(_same_bits(placed[k], params[k], path + (k,))
                   for k in params)
    local = placed.to_local()
    if not (local.dtype == params.dtype and local.device == params.device
            and torch.equal(local.view(torch.uint8),
                            params.view(torch.uint8))):
        raise RuntimeError(f"leaf {'/'.join(path)} changed in placement")
    return 1


def drive_mesh_and_collectives(dev) -> dict:
    """Phase 16 (a) and (b)."""
    import torch

    from repro_torch.ckpt.replicated_log import ReplicatedMetadataLog
    from repro_torch.configs import get_config
    from repro_torch.launch.elastic import WorldState, elastic_step, reshard_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import init_params
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import distribute, param_shardings

    mesh = make_host_mesh()
    out = {"mesh": {"shape": list(mesh.mesh.shape),
                    "dims": list(mesh.mesh_dim_names),
                    "device_type": mesh.device_type}}
    params = init_params(get_config("tinyllama-1.1b"), 0, device=dev)
    placed = distribute(params, param_shardings(params, mesh))
    out["leaves"] = _same_bits(placed, params)
    out["wq_placements"] = str(placed["layers"]["attn"]["wq"].placements)
    log = ReplicatedMetadataLog()
    world, new_mesh = elastic_step(WorldState(2, (2, 1)), [0], log=log)
    out["world"] = [world.n_devices, list(world.mesh_shape), world.generation]
    out["logged"] = log.current_scaling()
    if out["world"] != [1, [1, 1], 1] or out["logged"] != {
            "step": 1, "n_healthy": 1, "mesh": [1, 1]}:
        raise RuntimeError(f"elastic_step: {out}")
    if _same_bits(reshard_state(placed, new_mesh), params) != out["leaves"]:
        raise RuntimeError("reshard_state lost leaves")
    del placed, params
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(0)
    grads = {"wq": torch.randn(2048, 2048, generator=gen) * 1e-3,
             "b": (torch.randn(4096, generator=gen),)}
    on_card = {"wq": grads["wq"].to(dev), "b": (grads["b"][0].to(dev),)}
    checked = 0
    for mask in (1, 0):
        want = coll.deadline_masked_mean(grads, torch.tensor(mask))
        got = coll.deadline_masked_mean(on_card, torch.tensor(mask, device=dev))
        for a, b in ((got["wq"], want["wq"]), (got["b"][0], want["b"][0])):
            if not torch.equal(a.cpu(), b):
                raise RuntimeError(f"deadline_masked_mean (mask {mask}): "
                                   f"NCCL != gloo")
            checked += 1
    x = grads["wq"].reshape(-1)
    if not torch.equal(coll.compressed_allreduce(x.to(dev)).cpu(),
                       coll.compressed_allreduce(x)):
        raise RuntimeError("compressed_allreduce: NCCL != gloo")
    out["collectives_checked"] = checked + 1
    return out


def drive_hillclimb() -> dict:
    """Phase 16 (c): the hillclimb at batch 1 and P16_HILLCLIMB_LAYERS
    layers, the ssd_scan chunks probed."""
    from repro_torch.launch import hillclimb

    with ssd_chunk_probe() as chunks:
        records = hillclimb.run(batch=1, layers=P16_HILLCLIMB_LAYERS,
                                calls=P16_CALLS)
    failed = [r for r in records if r.get("status", "ok") != "ok"]
    if failed:
        raise RuntimeError(f"hillclimb steps failed: {failed}")
    one_card = [r for r in records if "note" in r]     # the dp_only steps
    if len(one_card) != 2 or any(r["verdict"] != "REFUTED" for r in one_card):
        raise RuntimeError(f"dp_only changed a term on one card: {one_card}")
    # every train step launches ssd_scan in each layer's forward and its
    # recompute, in each microbatch; each run makes 1 + calls steps
    want: dict = {}
    for r in records:
        if r["shape"] != "train_4k":
            continue
        if r["kernels"]["ssd_scan"] != 2 * r["n_layers"] * r["microbatches"]:
            raise RuntimeError(f"{r['arch']} {r['step']}: ssd_scan launched "
                               f"{r['kernels']['ssd_scan']} times, not 2 x "
                               f"{r['n_layers']} x {r['microbatches']}")
        chunk = r["overrides"].get("ssm_chunk", 128)
        want[chunk] = want.get(chunk, 0) + r["kernels"]["ssd_scan"] * (
            1 + r["calls"])
    by_chunk = {int(k): v for k, v in sorted(chunks.items())}
    if by_chunk != dict(sorted(want.items())) or set(want) != {128, 64, 32}:
        raise RuntimeError(f"ssd_scan calls by chunk {by_chunk}, expected "
                           f"{want} at chunks 128, 64 and 32")
    return {"records": records, "ssd_calls_by_chunk": by_chunk}


def drive_dryrun_cells(root: Path) -> dict:
    """Phase 16 (d): `run_cell` per P16_CELLS and the roofline table."""
    from repro_torch.analysis import roofline
    from repro_torch.launch.dryrun import run_cell

    out_dir = root / "build" / "phase16_dryrun"
    rows = []
    for arch, shape in P16_CELLS:
        print(f"=== {arch} x {shape} (16x16: one chip's batch) ===")
        r = run_cell(arch, shape, False, out_dir=str(out_dir), calls=P16_CALLS)
        rows.append(r)
        status = r["status"] + (f" ({r.get('reason')})" if r["status"] == "skipped"
                                else f" ({r.get('error')})" if r["status"] == "failed"
                                else "")
        print(f"  -> {status}")
    by = {(r["arch"], r["shape"]): r for r in rows}
    if by[("tinyllama-1.1b", "long_500k")]["status"] != "skipped":
        raise RuntimeError("tinyllama-1.1b x long_500k was not skipped")
    bad = [r for (a, s), r in by.items()
           if (a, s) != ("tinyllama-1.1b", "long_500k") and r["status"] != "ok"]
    if bad:
        raise RuntimeError(f"dry-run cells did not run: {bad}")
    train = by[("tinyllama-1.1b", "train_4k")]
    if train["kernels"]["flash_attention"] != 2 * 22 * train["microbatches"] \
            or train["n_layers"] != 22 \
            or by[("tinyllama-1.1b", "prefill_32k")]["kernels"][
                "flash_attention"] != 22:
        raise RuntimeError(f"the dry run's steps launched "
                           f"{[r.get('kernels') for r in rows]}")
    path = out_dir / "dryrun_results.json"
    path.write_text(json.dumps(rows, indent=1))
    print(roofline.to_markdown(roofline.analyze(str(path))))
    return {"rows": rows}


def drive_phase16(dev, root: Path) -> dict:
    import torch.distributed as dist

    t_phase = time.perf_counter()
    try:
        mc = drive_mesh_and_collectives(dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"one-rank NCCL DeviceMesh {json.dumps(mc['mesh'])}: "
          f"tinyllama-1.1b's {mc['leaves']} leaves placed as DTensors (wq "
          f"{mc['wq_placements']}) and back, bit for bit; elastic_step 2 -> 1 "
          f"device: world {mc['world']}, logged {json.dumps(mc['logged'])}, "
          f"reshard_state bit for bit; {mc['collectives_checked']} collective "
          f"results on NCCL == gloo, bit for bit")
    t0 = time.perf_counter()
    hc = drive_hillclimb()
    print(f"hillclimb (batch 1, {P16_HILLCLIMB_LAYERS} layers): "
          f"{len(hc['records'])} records, ssd_scan "
          f"calls by chunk {json.dumps(hc['ssd_calls_by_chunk'])}, "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dr = drive_dryrun_cells(root)
    print(f"dry-run cells: {time.perf_counter() - t0:.1f} s")
    wall = time.perf_counter() - t_phase
    print(f"phase 16 wall {wall:.1f} s")
    return {"mesh": mc, "hillclimb": hc, "dryrun": dr, "wall_s": wall}


def phase16_record(p16: dict, kernel: str) -> dict:
    """A kernel's phase-16 launches: by dry-run cell and by hillclimb step
    (one step of each)."""
    out = {"dryrun": {f"{r['arch']} x {r['shape']}": r["kernels"][kernel]
                      for r in p16["dryrun"]["rows"] if r["status"] == "ok"},
           "hillclimb": {f"{r['arch']} x {r['shape']} {r['step']}":
                         r["kernels"][kernel]
                         for r in p16["hillclimb"]["records"]}}
    if kernel == "ssd_scan":
        out["hillclimb_calls_by_chunk"] = p16["hillclimb"]["ssd_calls_by_chunk"]
    return out


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
        for arch, (n_layers, *_) in LM_PATHS.items():
            profile_lm_path(dev, arch, n_layers)
        profile_train_step(dev)
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
    diff = main_path_difference(gpu_cl, gpu_sum, cpu_cl, cpu_sum)
    if diff is not None:
        return fail(f"the card and the CPU runs differ: {diff}")
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
    for line in lm_lines("tinyllama-1.1b", lm):
        print(line)

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
    sm = drive_lm_path(dev, "mamba2-130m")
    for line in lm_lines("mamba2-130m", sm):
        print(line)

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

    # -- 11. nezha-sharded: batched DOM kernels, the deployment, scenarios --
    shard = drive_sharded(dev)

    # -- 12. the remaining model families at full width -----------------------
    print("flash_attention at phase 12's shapes (kernel vs plain, card):")
    fam_rows = []
    for label, B, S, Sk, Hq, Hk, D, causal, window in FAMILY_ATTENTION:
        for dtype in ("bfloat16", "float32"):
            r = check_attention(dev, B, S, Sk, Hq, Hk, D, dtype, causal,
                                window, timed=True)
            r["label"] = label
            fam_rows.append(r)
            print(f"  {label}: {r['shape']}: err {r['max_abs_err']:.3g}, "
                  f"{attention_line(r)}")
    families = {}
    for name in FAMILIES:
        t_fam = time.perf_counter()
        families[name] = drive_lm_path(dev, name)
        for line in lm_lines(name, families[name]):
            print(line)
        print(f"  ({time.perf_counter() - t_fam:.1f} s for {name})")

    # -- 13. the replicated services and the event-driven backends -------------
    from repro_torch.configs import get_config

    services = {}
    for name in SERVICE_ARCHS:
        services[name] = drive_service(dev, get_config(name), name)
        print(service_line(services[name], card))
    print("backend cross-check (benchmarks/figs.py, f 1, 10 clients, 0.2 s, "
          "open loop):")
    xcheck = drive_crosscheck()
    for row in xcheck:
        print(crosscheck_line(row))
    fig9 = drive_fig9()
    for name, r in fig9.items():
        print(f"fig 9 full ({name}, f 1, 3 proxies, 10 clients x "
              f"{FIG9_RATE:.0f} req/s, {FIG9_DURATION} s, host): "
              f"{r['committed']} of {r['n_requests']} committed, fast ratio "
              f"{r['fast_commit_ratio']:.4f}, median "
              f"{r['median_latency'] * 1e6:.1f} us, p90 "
              f"{r['p90_latency'] * 1e6:.1f} us, {r['events']} events, wall "
              f"{r['wall_s']:.3f} s ({r['wall_per_sim_s']:.2f} s per "
              f"simulated s)")

    # -- 14. training on the card ----------------------------------------------
    training = drive_training(dev)

    # -- 15. C4, the one-shot primitives, Figs 1-3, the sanitizer, examples ---
    p15 = drive_phase15(dev, root, rate, duration, (gpu_cl, gpu_sum, gpu_s),
                        scen, shard)

    # -- 16. sharding, collectives, meshes, the dry run and the hillclimb ------
    p16 = drive_phase16(dev, root)

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
        entry["sharded"] = {
            "batched": [{"G": r["G"], "n": r["n"], "requests": r["requests"],
                         **r[name]} for r in shard["batched"]],
            "deployment_launches_by_route": {
                f"G {G} {mode}": run["counts"][name]
                for G, modes in shard["runs"].items()
                for mode, run in modes.items()},
            "scenario_launches_by_route": {
                sc: v["launches_by_route"][name]
                for sc, v in shard["scenarios"].items()}}
        entry["crosscheck_launches_by_route"] = {
            f"{row['rate']:.0f}": row["nezha-vectorized"][
                "launches_by_route"][name] for row in xcheck}
        entry["one_shot_launches_by_route"] = {
            f"{prim} n {row['n']}": row[prim]["launches_by_route"][name]
            for row in p15["one_shot"]["rows"]
            for prim in ONE_SHOT_CALLS}
        if name == "dom_admit":
            entry["fig3_launches_by_route"] = [
                r["launches_by_route"]["dom_admit"]
                for r in p15["figs"]["fig3"][1:]]
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
            "tail_max_abs_err")},
        "families": {name: {"prefill_launches": r["launches"][
            "flash_attention"], "by_route": r["attention_routes"],
            "serving_launches": r["serve"]["attention_launches"]}
            for name, r in families.items()},
        "replicated_services": {name: {
            "launches": r["launches"], "by_route": r["attention_routes"],
            "decode_steps": r["decode_steps"]}
            for name, r in services.items()},
        "family_shapes": [{k: r.get(k) for k in (
            "label", "shape", "route", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "scalar_ms", "tflops")}
            for r in fam_rows],
        "training": training_record(training, "flash_attention"),
        "small_head_dims": [{k: r.get(k) for k in (
            "shape", "route", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "tflops")}
            for r in p15["small_heads"]],
        "small_head_paths": p15["small_head_paths"],
        "phase16": phase16_record(p16, "flash_attention")})
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
        "prefill_32k": {k: ssd_32k[k] for k in ssd_keys},
        "families": {name: r["launches"]["ssd_scan"]
                     for name, r in families.items()},
        "training": training_record(training, "ssd_scan"),
        "phase16": phase16_record(p16, "ssd_scan")})
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
