"""One-card dry run: every (architecture x input shape) cell's step, counted
and measured on one H100.

Port of `repro/launch/dryrun.py`, recast for one card. The reference lowers
and compiles each cell on a 512-device host mesh and reads XLA's cost and
memory analyses. Here `run_cell` does four things:

(a) an abstract pass on the CPU: the step under `FakeTensorMode` (no
    storage), its aten ops recorded and counted by
    `repro_torch.analysis.ops` (FLOPs, bytes, collectives; each
    hand-written kernel as one op with its own FLOPs and bytes, as the card
    runs it). The step is recorded at the least depth (0 layers; 1 for the
    encoder-decoder) and one layer deeper in each stack, and extrapolated
    to the run's depth (every count is affine in it); the listing is saved
    as <arch>__<shape>__<pod>[<variant>].ops.json.gz;
(b) per-device argument bytes on the production mesh (16x16, or 2x16x16):
    params, optimizer state, batch and cache, each leaf's local shape from
    the sharding rules (`shard_shape`);
(c) the card run of the cell's step (`make_train_step`, `make_prefill` or
    `make_decode_step`; serving weights in the config's
    `serve_params_dtype`) at the batch the rules give one chip of the
    production mesh (train_4k 16 x 4096, prefill_32k 2 x 32768, decode_32k
    8 with a 32768 cache, long_500k 1) or at ``batch``: ``step_s`` is the
    mean of ``calls`` calls timed with CUDA events after a warm one; peak
    bytes; `flash_attention` and `ssd_scan` launches in one step. A cell
    runs at full depth and one microbatch first; out of memory, it is cut
    (train: twice the microbatches while they divide the batch; then half
    the layers) and says so in ``reduced``; if one layer does not fit it is
    skipped with the reason;
(d) the reference's result keys, restated for one card: ``n_chips`` 1;
    ``lower_s`` the abstract pass's seconds, ``compile_s`` the first
    (warm) call's; ``flops_raw`` / ``bytes_accessed_raw`` one layer's
    probe counted once (as XLA counts a loop body once); ``flops`` /
    ``bytes_accessed`` / ``collective_bytes`` the step's at the run's
    depth; ``memory`` the production mesh's per-device argument bytes.
    Beside them: ``device`` (name and power limit), ``batch``,
    ``n_layers``, ``microbatches``, ``reduced``, ``step_s``,
    ``peak_bytes`` and ``kernels``.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import pathlib
import subprocess
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.analysis.ops import (
    collective_bytes_from_ops,
    record_ops,
    save_listing,
)
from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs.shapes import (
    SHAPES,
    input_specs,
    sequence_batch,
    shape_applicable,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import rope_freqs
from repro_torch.models.model import (
    abstract_cache,
    abstract_params,
    init_params,
    make_decode_step,
    make_prefill,
    zero_cache,
)
from repro_torch.parallel import sharding as sh
from repro_torch.train.train_step import make_train_state, make_train_step

TIMED_CALLS = 3


@functools.lru_cache(maxsize=None)
def card_info(device: str) -> dict:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = [x.strip() for x in smi.stdout.strip().split(",")]
    return {"name": name, "power_limit": limit}


# ---------------------------------------------------------------------------
# (b) the production mesh: per-chip batch and per-device argument bytes
# ---------------------------------------------------------------------------
def _local_bytes(tree, shardings) -> int:
    return sum(math.prod(s.shard_shape(x.shape)) * x.element_size()
               for x, s in zip(tree_leaves(tree), tree_leaves(shardings)))


def _serve_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.serve_params_dtype)


def per_chip_batch(cfg, shape: str, multi_pod: bool) -> int:
    """The batch one chip of the production mesh holds (the batch rule's
    local leading dim)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind, specs = input_specs(cfg, shape)
    tokens = specs["tokens"] if kind == "decode" else specs["batch"]["tokens"]
    local = sh.batch_shardings(tokens, mesh, dp_only=cfg.dp_only or cfg.ddp)
    return local.shard_shape(tokens.shape)[0]


def argument_bytes(cfg, shape: str, multi_pod: bool) -> dict:
    """Per-device bytes of the step's arguments on the production mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind, specs = input_specs(cfg, shape)
    out = {"params": 0, "optimizer": 0, "batch": 0, "cache": 0}
    if kind == "train":
        state = make_train_state(cfg)                # abstract
        p_sh = sh.param_shardings(state.params, mesh, dp_only=cfg.dp_only,
                                  ddp=cfg.ddp)
        out["params"] = _local_bytes(state.params, p_sh)
        out["optimizer"] = (_local_bytes(state.opt.m, p_sh)
                            + _local_bytes(state.opt.v, p_sh)
                            + state.opt.step.element_size())
    else:
        params = abstract_params(cfg, dtype=_serve_dtype(cfg))
        p_sh = sh.param_shardings(params, mesh, tp_only=cfg.serve_tp_only,
                                  dp_only=cfg.dp_only, ddp=cfg.ddp)
        out["params"] = _local_bytes(params, p_sh)
    batch = specs["tokens"] if kind == "decode" else specs["batch"]
    out["batch"] = _local_bytes(batch, sh.batch_shardings(
        batch, mesh, dp_only=cfg.dp_only or cfg.ddp))
    if kind == "decode":
        out["cache"] = (_local_bytes(specs["cache"], sh.cache_shardings(
            specs["cache"], mesh)) + specs["cache_len"].element_size())
    out["total"] = sum(out.values())
    return out


def _depth(cfg, n_layers: int):
    return dataclasses.replace(cfg, n_layers=n_layers)


# ---------------------------------------------------------------------------
# (a) the abstract pass
# ---------------------------------------------------------------------------
def _step_and_args(cfg, kind: str, B: int, S: int, microbatches: int):
    """The step function and its arguments as meta tensors."""
    if kind == "train":
        return (make_train_step(cfg, microbatches=microbatches),
                (make_train_state(cfg), sequence_batch(cfg, B, S)))
    params = abstract_params(cfg, dtype=_serve_dtype(cfg))
    if kind == "prefill":
        return make_prefill(cfg), (params, sequence_batch(cfg, B, S))
    cache = abstract_cache(cfg, B, S, src_len=S // 2 if cfg.enc_dec else 0)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    return make_decode_step(cfg), (params, cache, tokens, S - 1)


def _depth_fields(cfg) -> tuple:
    return ("n_layers", "n_enc_layers") if cfg.enc_dec else ("n_layers",)


def _low(cfg) -> int:
    """The probes' least depth: 0 layers, but 1 for the encoder-decoder,
    which stacks its layers' cross K/V."""
    return 1 if cfg.enc_dec else 0


def probe_weights(cfg, depths: dict) -> list:
    """[(probe depths, weight)]: the base probe at the least depth of every
    stack, and one probe a stack one layer deeper; weighted so that their
    sum is the step at ``depths`` (each count is affine in each depth)."""
    low = _low(cfg)
    base = {f: low for f in _depth_fields(cfg)}
    out = [(base, 1.0 - sum(depths[f] - low for f in base))]
    for f in base:
        out.append(({**base, f: low + 1}, float(depths[f] - low)))
    return out


def reweight(cfg, listing: dict, depths: dict) -> dict:
    """``listing``'s probes weighted for another depth."""
    weights = [w for _, w in probe_weights(cfg, depths)]
    return {"probes": [{**p, "weight": w}
                       for p, w in zip(listing["probes"], weights)]}


def abstract_pass(cfg, kind: str, B: int, S: int, microbatches: int) -> dict:
    """The step's listing as weighted probes (`probe_weights` at the
    config's depth)."""
    depths = {f: getattr(cfg, f) for f in _depth_fields(cfg)}
    out = []
    try:
        for probe, weight in probe_weights(cfg, depths):
            # rope tables are cached per device: keep fake ones out of the
            # cache the real runs read
            rope_freqs.cache_clear()
            fn, args = _step_and_args(dataclasses.replace(cfg, **probe), kind,
                                      B, S, microbatches)
            out.append({"depth": probe, "weight": weight,
                        "ops": record_ops(fn, *args)})
    finally:
        rope_freqs.cache_clear()
    return {"probes": out}


# ---------------------------------------------------------------------------
# (c) the card run
# ---------------------------------------------------------------------------
class NoFit(Exception):
    """No cut of the cell fits the card."""


def _card_batch(cfg, B: int, S: int, dev, gen) -> dict:

    out = {}
    for k, v in sequence_batch(cfg, B, S).items():
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab, tuple(v.shape), generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            out[k] = torch.randn(tuple(v.shape), generator=gen, device=dev,
                                 dtype=v.dtype)
    return out


def _card_step(cfg, kind: str, B: int, S: int, microbatches: int, dev,
               calls: int) -> dict:
    """Build the step's state on ``dev``, run it once (warm) with the
    kernels' launch counts reset just before and read just after, then
    ``calls`` times between CUDA events. Every output must be finite."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if kind == "train":
        holder = {"state": make_train_state(cfg, seed=0, device=dev)}
        batch = _card_batch(cfg, B, S, dev, gen)
        step = make_train_step(cfg, microbatches=microbatches)

        def call():
            holder["state"], metrics = step(holder["state"], batch)
            return metrics["loss"]
    else:
        pdt = _serve_dtype(cfg)
        params = tree_map(lambda t: t.to(pdt), init_params(cfg, 0, device=dev))
        if kind == "prefill":
            batch = _card_batch(cfg, B, S, dev, gen)
            prefill = make_prefill(cfg)

            def call():
                return prefill(params, batch)[0]
        else:
            cache = zero_cache(cfg, B, S, S // 2 if cfg.enc_dec else 0,
                               device=dev)
            tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                                   device=dev, dtype=torch.int32)
            decode = make_decode_step(cfg)

            def call():
                return decode(params, cache, tokens, S - 1)[0]

    fa.launches = 0
    ssd.launches = 0
    t0 = time.perf_counter()
    out = call()
    finite = torch.isfinite(out.float()).all()
    if cuda:
        torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    kernels = {"flash_attention": fa.launches, "ssd_scan": ssd.launches}
    res = {"compile_s": warm_s, "kernels": kernels, "step_s": None,
           "peak_bytes": None, "calls": 0}
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            out = call()
            finite = finite & torch.isfinite(out.float()).all()
        end.record()
        torch.cuda.synchronize(dev)
        res.update(step_s=start.elapsed_time(end) / 1e3 / calls,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   calls=calls)
    if not bool(finite.cpu()):
        raise FloatingPointError("the step's output is not finite")
    return res


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def fit_and_run(cfg, kind: str, B: int, S: int, dev, calls: int,
                reduced: list) -> tuple:
    """The card run at full depth and one microbatch; out of memory, the
    next cut (train: twice the microbatches while they divide the batch;
    then half the layers). Returns (the run's config, microbatches, results);
    raises `NoFit`."""
    n_layers, mb = cfg.n_layers, 1
    while True:
        run_cfg = _depth(cfg, n_layers)
        try:
            return run_cfg, mb, _card_step(run_cfg, kind, B, S, mb, dev,
                                           calls)
        except torch.cuda.OutOfMemoryError as e:
            why = str(e).splitlines()[0][:160]
        _free(dev)
        if kind == "train" and B % (2 * mb) == 0:
            mb *= 2
            reduced.append(f"microbatches {mb} (out of memory: {why})")
        elif n_layers > 1:
            n_layers //= 2
            reduced.append(f"n_layers -> {n_layers} (out of memory: {why})")
        else:
            raise NoFit(f"out of memory at one layer, {mb} microbatches: "
                        f"{why}")


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str | None = None,
             save_ops: bool = True, verbose: bool = True,
             overrides: dict | None = None, tag_suffix: str = "", *,
             device="cuda", batch: int | None = None,
             layers: int | None = None, calls: int = TIMED_CALLS) -> dict:
    """One cell (see the module's docstring). ``batch`` and ``layers``
    replace one chip's batch and the config's depth on the card (each
    listed in ``reduced``; the production mesh's argument bytes stay the
    full cell's). On ``device="cpu"`` the step runs once and nothing is
    timed (``step_s`` and ``peak_bytes`` None)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ok, reason = shape_applicable(cfg, shape)
    res = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
           "variant": tag_suffix or "baseline", "overrides": overrides or {}}
    if not ok:
        res.update(status="skipped", reason=reason)
        return res
    dev = resolve_device(device)
    sp = SHAPES[shape]
    kind, S = sp.kind, sp.seq_len
    reduced: list = []
    try:
        B = per_chip_batch(cfg, shape, multi_pod)
        if batch is not None and batch != B:
            reduced.append(f"batch {B} -> {batch} (asked)")
            B = batch
        args = argument_bytes(cfg, shape, multi_pod)
        asked = cfg
        if layers is not None and layers != cfg.n_layers:
            reduced.append(f"n_layers {cfg.n_layers} -> {layers} (asked)")
            asked = _depth(cfg, layers)
        try:
            run_cfg, mb, card = fit_and_run(asked, kind, B, S, dev, calls,
                                            reduced)
        except NoFit as e:
            res.update(status="skipped", reason=f"does not fit the card: {e}",
                       reduced=reduced, device=card_info(str(dev)))
            return res
        t0 = time.perf_counter()
        listing = abstract_pass(run_cfg, kind, B, S, mb)
        lower_s = time.perf_counter() - t0
        coll = collective_bytes_from_ops(listing)
        raw = collective_bytes_from_ops(reweight(
            run_cfg, listing, {f: 1 for f in _depth_fields(run_cfg)}))
        res.update(
            status="ok", kind=kind, n_chips=1,
            lower_s=round(lower_s, 1), compile_s=round(card["compile_s"], 1),
            flops_raw=raw["dot_flops"], bytes_accessed_raw=raw["memory_bytes"],
            flops=float(coll["dot_flops"]),
            bytes_accessed=float(coll["memory_bytes"]),
            collective_bytes=coll,
            memory={"argument_size_bytes": args["total"]},
            argument_bytes=args,
            device=card_info(str(dev)), batch=B, seq_len=S,
            n_layers=run_cfg.n_layers, microbatches=mb, reduced=reduced,
            step_s=card["step_s"], peak_bytes=card["peak_bytes"],
            calls=card["calls"], kernels=card["kernels"])
        if out_dir and save_ops:
            p = pathlib.Path(out_dir)
            p.mkdir(parents=True, exist_ok=True)
            tag = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}{tag_suffix}"
            save_listing(p / f"{tag}.ops.json.gz", listing)
        if verbose:
            step = "not measured" if card["step_s"] is None \
                else f"{card['step_s']:.4f} s"
            peak = "not measured" if card["peak_bytes"] is None \
                else f"{card['peak_bytes'] / 2**30:.2f} GiB"
            print(f"  production mesh: args {args['total'] / 2**30:.2f} GiB a "
                  f"device ({json.dumps({k: v for k, v in args.items() if k != 'total'})})")
            print(f"  card ({res['device']['name']}, "
                  f"{res['device']['power_limit']}): batch {B} x {S}, "
                  f"{run_cfg.n_layers} layers, microbatches {mb}, step "
                  f"{step}, peak {peak}, kernels {json.dumps(card['kernels'])}"
                  + (f", reduced {reduced}" if reduced else ""))
            print(f"  ops: flops={res['flops']:.3e} bytes={res['bytes_accessed']:.3e} "
                  f"(abstract pass {lower_s:.1f} s)")
    except Exception as e:  # noqa: BLE001 -- report the cell as failed
        res.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    finally:
        _free(dev)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-ops", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--calls", type=int, default=TIMED_CALLS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()


    archs = all_arch_names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stamp = out / "dryrun_results.json"
    results = []
    for mp in pods:
        for a in archs:
            for s in shapes:
                print(f"=== {a} x {s} ({'2x16x16' if mp else '16x16'}) ===", flush=True)
                t0 = time.perf_counter()
                r = run_cell(a, s, mp, out_dir=args.out, save_ops=not args.no_ops,
                             device=args.device, batch=args.batch,
                             layers=args.layers, calls=args.calls)
                print(f"  -> {r['status']}" + (f" ({r.get('reason','')})" if r['status'] == 'skipped'
                                               else (f" ERROR {r.get('error','')}" if r['status'] == 'failed' else ""))
                      + f" [{time.perf_counter() - t0:.1f} s]", flush=True)
                results.append(r)
                _write(stamp, results)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "failed" for r in results)
    print(f"\nDRY-RUN SUMMARY: ok={n_ok} skipped={n_skip} failed={n_fail}")
    if n_fail:
        raise SystemExit(1)


def _write(stamp: pathlib.Path, results: list) -> None:
    """Merge ``results`` into the results file (a cell replaces its older
    record), after every cell, so a cut run keeps what it finished."""
    existing = json.loads(stamp.read_text()) if stamp.exists() else []
    keys = {(r["arch"], r["shape"], r["multi_pod"], r["variant"])
            for r in results}
    existing = [r for r in existing
                if (r["arch"], r["shape"], r["multi_pod"], r["variant"]) not in keys]
    stamp.write_text(json.dumps(existing + results, indent=1))


if __name__ == "__main__":
    main()
