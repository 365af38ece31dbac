#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), torch/CUDA/nvcc versions;
  2. build of the CUDA kernels from the checkout's sources (seconds);
  3. each kernel against its plain torch version on the card, exact, on a
     realistic DOM batch (lognormal 60 us one-way delays, 2 % drops,
     deadlines at send + 120 us) at n in {1e4, 1e5, 1e6} and R = 3, timed
     with CUDA events beside the plain version and, for dom_release, one
     stable `torch.sort` of the same keys;
  4. the main path: `make_cluster("nezha-vectorized")` driven by the
     `WorkloadDriver` -- 3 replicas (f = 1), 1 proxy, 10 ms epochs,
     open-loop Poisson at 1e6 req/s, 50 % reads, Zipf 0.5 over 1 M keys,
     per-key-class commutativity, 0.2 s, K = 16 epoch windows -- on the
     card with the launch counts reset just before and read just after,
     then the same run on the CPU (plain versions), which must agree bit
     for bit.
The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}. The script imports nothing of JAX or `repro`.

``python3 chip_smoke.py --profile`` instead runs phases 1-2 and then the
card half of phase 4 twice -- once to warm, once under `torch.profiler`
(device time by kernel, device busy share of the wall time) and cProfile
(where the host time goes). Profiling slows the run; the plain run's wall
time is the one phase 4 prints.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
SIZES = (10_000, 100_000, 1_000_000)
MAIN_N_PAD = 16_384             # pow2 bucket of ~1e4 requests per epoch


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


def check_kernels(dev, n: int, n_pad: int | None = None) -> dict:
    """Each kernel's wrapper on card tensors (which launches the kernel) ==
    its plain version on the same tensors, exactly; times in ms."""
    import numpy as np
    import torch

    from repro_torch.kernels.dom_admit import dom_admit, dom_admit_plain
    from repro_torch.kernels.dom_release import (dom_release,
                                                 dom_release_plain)
    from repro_torch.kernels.timekeys import time_sort_keys

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
    # the engine's use: all admitted, clock at +inf; plus a masked drain
    rel_in = adm_p[:, 0].contiguous()
    now = float(np.quantile(d_np[np.isfinite(d_np)], 0.5))
    release_err = 0
    for adm, clock in ((torch.ones(m, dtype=torch.bool, device=dev),
                        float("inf")), (rel_in, now)):
        o_k, c_k = dom_release(d, adm, clock)
        o_p, c_p = dom_release_plain(d, adm, clock)
        torch.cuda.synchronize()
        release_err = max(release_err, int((o_k.to(torch.int64)
                                            - o_p.to(torch.int64))
                                           .abs().max()))
        if not (torch.equal(o_k, o_p) and int(c_k) == int(c_p)):
            raise RuntimeError(f"dom_release disagrees with its plain "
                               f"version at n={m}, now={clock}")
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    keys = time_sort_keys(d)
    inf = float("inf")
    return {
        "n": m, "R": R,
        "dom_admit": {
            "max_abs_err": admit_err,
            "ms": time_ms(lambda: dom_admit(d, a)),
            "plain_ms": time_ms(lambda: dom_admit_plain(d, a)),
            "bound_ms": (8 * m + 8 * R * m + R * m) / HBM_BYTES_PER_S * 1e3,
            "library_ms": None,
        },
        "dom_release": {
            "max_abs_err": release_err,
            "ms": time_ms(lambda: dom_release(d, ones, inf)),
            "plain_ms": time_ms(lambda: dom_release_plain(d, ones, inf)),
            "bound_ms": (9 * m + 4 * m) / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_ms(lambda: torch.sort(keys, stable=True)),
        },
    }


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the card run of the main path instead "
                             "of the smoke phases 3-4")
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
    per_source = build.build_all(extra_flags=("-Xptxas=-v",))
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + json.dumps({k: round(v, 1) for k, v in per_source.items()}))

    rate, duration = 1e6, 0.2
    if args.profile:
        profile_main_path(rate, duration)
        return 0

    # -- 3. kernels vs plain versions ------------------------------------------
    from repro_torch.kernels import dom_admit as admit_mod
    from repro_torch.kernels import dom_release as release_mod

    print("kernel      n        R  ms        plain_ms  bound_ms  library_ms")
    for n in SIZES:
        res = check_kernels(dev, n)
        for name in ("dom_admit", "dom_release"):
            r = res[name]
            lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
                   else "-")
            print(f"{name:11s} {n:<8d} {res['R']}  {r['ms']:<9.4f} "
                  f"{r['plain_ms']:<9.4f} {r['bound_ms']:<9.5f} {lib}")
    main_shape = check_kernels(dev, 10_000, n_pad=MAIN_N_PAD)

    # -- 4. the main path ----------------------------------------------------------
    admit_mod.launches = 0
    release_mod.launches = 0
    gpu_cl, gpu_sum, gpu_s = drive_main_path("cuda", rate, duration)
    launches = {"dom_admit": admit_mod.launches,
                "dom_release": release_mod.launches}
    epochs = gpu_sum["epochs"]
    print(f"main path on {torch.cuda.get_device_name(0)}: "
          f"{gpu_sum['n_requests']} requests, {gpu_sum['committed']} "
          f"committed, fast ratio {gpu_sum['fast_commit_ratio']:.4f}, "
          f"median {gpu_sum['median_latency'] * 1e6:.1f} us, "
          f"p90 {gpu_sum['p90_latency'] * 1e6:.1f} us, {epochs} epochs "
          f"({gpu_sum['batches']} with requests), wall {gpu_s:.2f} s, "
          f"launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            return fail(f"the main path never launched {name}")
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

    record = {"kernels": []}
    for name, src, replaces in (
            ("dom_admit", "src/repro_torch/kernels/csrc/dom_admit.cu",
             "src/repro/kernels/dom_admit.py:149"),
            ("dom_release", "src/repro_torch/kernels/csrc/dom_release.cu",
             "src/repro/kernels/dom_release.py:59")):
        r = main_shape[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "n": main_shape["n"], "R": main_shape["R"]})
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
