#!/usr/bin/env python3
"""Tile shapes of the inchash kernel on one NVIDIA GPU.

Builds src/repro_torch/kernels/csrc/inchash.cu once per (threads, items)
shape with -DINCHASH_THREADS / -DINCHASH_ITEMS (all builds at once), holds
each shape against the plain version bit for bit and times it with CUDA
events (eager, and replayed from a CUDA graph) at the hash path's log size
(180191 entries), 1e6 and 2^24 entries, the shapes in turns (forward, then
backward). Then the host time of one call at 180191 entries: through the
wrapper (`inchash_cuda`) and through the bare ctypes launch, each from the
host clock over 2000 calls without a sync (the device work of a call is
shorter than either).

Run from the root of a checkout:  python3 scripts/inchash_tiles.py
The last two lines are a JSON record and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SHAPES = ((512, 8), (256, 8), (256, 16), (512, 4), (1024, 4))
SIZES = (180_191, 1_000_000, 1 << 24)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet


def build_shapes() -> dict:
    """{(threads, items): the loaded library}, compiled in parallel."""
    from repro_torch.kernels import build

    out_dir = build.build_dir() / "inchash_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for threads, items in SHAPES:
        target = out_dir / f"inchash_t{threads}_i{items}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS,
               f"-DINCHASH_THREADS={threads}", f"-DINCHASH_ITEMS={items}",
               "-o", str(target), str(build.CSRC / "inchash.cu")]
        procs[(threads, items)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), target)
    libs = {}
    for shape, (proc, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {shape}:\n{log}")
        libs[shape] = ctypes.CDLL(str(target))
    return libs


def main() -> int:
    import torch

    from chip_smoke import synthetic_log, time_graph_ms, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import inchash as ih

    if not torch.cuda.is_available():
        print("inchash_tiles: no GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    libs = build_shapes()
    fns = {s: build.bind(lib, "inchash_launch", ih._ARGS)
           for s, lib in libs.items()}
    record = {"card": card, "sizes": {}}
    for n in SIZES:
        cols = [torch.as_tensor(x, device=dev)
                for x in synthetic_log(n, seed=n)]
        want = [x.view(torch.int32) for x in ih.inchash_plain(*cols)]
        runs = {}
        for shape, fn in fns.items():
            tiles = -(-n // (shape[0] * shape[1]))
            cap = max(ih.MIN_CAP, 1 << (tiles - 1).bit_length())
            area = torch.zeros(ih.HEADER_WORDS + 2 * cap, dtype=torch.int32,
                               device=dev)
            out = torch.empty((2, n), dtype=torch.uint32, device=dev)

            def launch(fn=fn, area=area, cap=cap, out=out):
                code = fn(*(x.data_ptr() for x in cols), n, out[0].data_ptr(),
                          out[1].data_ptr(), area.data_ptr(), cap,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed ({code})")

            launch()
            torch.cuda.synchronize()
            if not all(torch.equal(o.view(torch.int32), w)
                       for o, w in zip(out, want)):
                raise RuntimeError(f"shape {shape} disagrees at n={n}")
            runs[shape] = (launch, {"ms": [], "graph_ms": []})
        order = list(fns)
        for turn in (order, order[::-1]):
            for shape in turn:
                launch, res = runs[shape]
                res["ms"].append(time_ms(launch))
                res["graph_ms"].append(time_graph_ms(launch))
        bound = 32 * n / HBM_BYTES_PER_S * 1e3
        record["sizes"][n] = {"bound_ms": bound, "shapes": {
            f"{t}x{i}": res for (t, i), (_, res) in runs.items()}}
        for (t, i), (_, res) in runs.items():
            print(f"n {n}, {t} threads x {i} items (tile {t * i}): ms "
                  f"{json.dumps([round(x, 5) for x in res['ms']])}, graph "
                  f"{json.dumps([round(x, 5) for x in res['graph_ms']])}, "
                  f"bound {bound:.6f}")
    cols = [torch.as_tensor(x, device=dev)
            for x in synthetic_log(180_191, seed=1)]
    out = torch.empty((2, 180_191), dtype=torch.uint32, device=dev)
    fn = build.bind(build.library("inchash"), "inchash_launch", ih._ARGS)
    area, cap = ih._work_area(dev, torch.cuda.current_stream().cuda_stream,
                              -(-180_191 // ih.TILE))
    args = (*(x.data_ptr() for x in cols), 180_191, out[0].data_ptr(),
            out[1].data_ptr(), area.data_ptr(), cap,
            torch.cuda.current_stream().cuda_stream)
    host_us = {}
    for name, call in (("wrapper", lambda: ih.inchash_cuda(*cols)),
                       ("bare_launch", lambda: fn(*args)),
                       ("wrapper_again", lambda: ih.inchash_cuda(*cols))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        host_us[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    record["host_us_per_call"] = host_us
    print(f"host us per call at n 180191: {json.dumps(host_us)}")
    print(json.dumps(record))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
