"""Perf hillclimbing on the three selected (arch x shape) cells, on one H100.

Port of `repro/launch/hillclimb.py`: the same cells, hypotheses and
override steps. Each iteration records hypothesis -> change -> before/after
roofline terms (`repro_torch.analysis.roofline`'s H100 constants, from
the dry run's op counts, each hand-written kernel one op with its own
FLOPs and bytes) and the card's measured step time ->
CONFIRMED/REFUTED. The verdict rule is the reference's: CONFIRMED when the
dominant term falls by more than 5 %. Every run of a cell is at the
baseline's batch, so a change is judged at one batch.

On one card the sharding rules touch no step: `dp_only` changes only the
production mesh's layout, the card runs no collective, and its terms do not
move (each such iteration's record says so).

Results go to results/hillclimb_torch.json.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--batch 1] [--layers 4]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.analysis.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.launch.dryrun import run_cell

SHARDING_ONLY = {"dp_only", "ddp", "serve_tp_only"}
ONE_CARD_NOTE = ("on one card this changes only the production mesh's "
                 "sharding rules: the card runs no collective, so no term "
                 "can move")


def terms(res: dict) -> dict:
    c = res["flops"] / PEAK_FLOPS
    m = res["bytes_accessed"] / HBM_BW
    k = res["collective_bytes"]["total_bytes"] / LINK_BW
    dom = max(("compute", c), ("memory", m), ("collective", k), key=lambda t: t[1])
    return {"compute_s": c, "memory_s": m, "collective_s": k,
            "dominant": dom[0], "bound_s": dom[1], "step_s": res["step_s"]}


def _run_fields(res: dict) -> dict:
    """What a record keeps of the card run: its cut and the kernels' launches
    in one step."""
    return {k: res[k] for k in ("batch", "n_layers", "microbatches", "calls",
                                "reduced", "kernels")}


def _s(x) -> str:
    return "not measured" if x is None else f"{x:.4g}s"


def iterate(arch: str, shape: str, steps: list[dict], out: list, *,
            batch: int | None = None, layers: int | None = None,
            device="cuda", calls: int = 3) -> None:
    print(f"\n#### cell: {arch} x {shape} (one card)")

    def _run(**kw) -> dict:
        return run_cell(arch, shape, multi_pod=False, verbose=False,
                        device=device, batch=batch, layers=layers,
                        calls=calls, **kw)

    base = _run(tag_suffix="__base")
    if base["status"] != "ok":
        raise RuntimeError(f"{arch} x {shape} baseline: {base}")
    batch = base["batch"]
    cur = terms(base)
    print(f"baseline: compute={cur['compute_s']:.3e}s memory={cur['memory_s']:.3e}s "
          f"collective={cur['collective_s']:.3e}s dominant={cur['dominant']} "
          f"step={_s(cur['step_s'])} (batch {batch}, reduced {base['reduced']})")
    out.append({"arch": arch, "shape": shape, "step": "baseline",
                "overrides": {}, **_run_fields(base), **cur})
    acc: dict = {}
    for i, step in enumerate(steps):
        acc = {**acc, **step["overrides"]}
        print(f"\niter {i+1}: HYPOTHESIS: {step['hypothesis']}")
        print(f"  CHANGE: {step['overrides']}  (napkin: {step['napkin']})")
        res = _run(overrides=dict(acc), tag_suffix=f"__it{i+1}")
        if res["status"] != "ok":
            print(f"  FAILED: {res.get('error') or res.get('reason')}")
            out.append({"arch": arch, "shape": shape, "step": f"iter{i+1}",
                        "overrides": dict(acc), "status": res["status"],
                        "error": res.get("error") or res.get("reason")})
            continue
        new = terms(res)
        delta = (cur["bound_s"] - new["bound_s"]) / cur["bound_s"]
        verdict = "CONFIRMED" if new[f"{cur['dominant']}_s"] < cur[f"{cur['dominant']}_s"] * 0.95 \
            else "REFUTED"
        print(f"  AFTER: compute={new['compute_s']:.3e}s memory={new['memory_s']:.3e}s "
              f"collective={new['collective_s']:.3e}s dominant={new['dominant']} "
              f"step={_s(new['step_s'])}")
        print(f"  bound step-time: {cur['bound_s']:.3e}s -> {new['bound_s']:.3e}s "
              f"({delta*100:+.1f}%)  [{verdict}]")
        rec = {"arch": arch, "shape": shape, "step": f"iter{i+1}",
               "hypothesis": step["hypothesis"], "napkin": step["napkin"],
               "overrides": dict(acc), **_run_fields(res), **new,
               "bound_delta_pct": delta * 100, "verdict": verdict}
        if set(step["overrides"]) <= SHARDING_ONLY:
            rec["note"] = ONE_CARD_NOTE
            print(f"  NOTE: {ONE_CARD_NOTE}")
        out.append(rec)
        cur = new


CELLS = [
    # ---- cell 1: most collective-bound --------------------------------------
    ("mamba2-130m", "train_4k", [
        {"hypothesis": "TP=16 on a 768-wide model wastes ICI: every layer "
                       "all-reduces [B,S,768] activations fwd+bwd; folding the "
                       "model axis into data (pure FSDP over 256 ways) removes "
                       "them, leaving only per-layer weight gathers "
                       "(~130M*4B*3passes ~ 1.6GB/dev) and grad reduce-scatter.",
         "napkin": "collective 27.6s -> ~0.1s (~250x); memory/compute unchanged",
         "overrides": {"dp_only": True}},
        {"hypothesis": "with collectives gone, memory dominates; the SSD "
                       "chunk=128 >> N=16 wastes the intra-chunk quadratic "
                       "form: shrink to chunk=64 (still MXU-aligned on P=64).",
         "napkin": "intra-chunk flops/bytes ~ Q/2: ~2x less SSD traffic",
         "overrides": {"ssm_chunk": 64}},
    ]),
    # ---- cell 2: worst roofline fraction ------------------------------------
    ("hymba-1.5b", "train_4k", [
        {"hypothesis": "full remat recomputes every matmul in the backward: "
                       "switching to dots_saveable keeps MXU outputs resident, "
                       "cutting compute ~1.7x and (counted) memory traffic for "
                       "the recompute pass.",
         "napkin": "compute 11.5s -> ~7s; memory down ~25%",
         "overrides": {"remat": "dots"}},
        {"hypothesis": "SSD chunk=128 with N=16 state: the [Q,Q] dual form "
                       "costs ~Q*H*P flops/token vs ~N*H*P for the scan; "
                       "chunk=32 cuts intra-chunk work 4x with 4x more "
                       "(cheap) state carries.",
         "napkin": "SSD flops ~4x less; attention unchanged",
         "overrides": {"ssm_chunk": 32}},
        {"hypothesis": "1.5B params with TP=16 leaves tiny per-device matmuls "
                       "(d_ff/16=344) and activation all-reduces; pure FSDP "
                       "(dp_only) removes TP collectives and restores "
                       "MXU-friendly tile sizes.",
         "napkin": "collective ~10x less; compute unchanged",
         "overrides": {"dp_only": True}},
    ]),
    # ---- cell 3: most representative of the paper (serving/decode) ----------
    ("qwen2-7b", "decode_32k", [
        {"hypothesis": "decode re-gathers fp32 FSDP-sharded weights every "
                       "step (1.9GB/dev over ICI). Serving needs no optimizer "
                       "sharding: replicate weights across the data axis "
                       "(TP-only) in bf16 -> the all-gather disappears and "
                       "weight reads halve.",
         "napkin": "collective 24.8ms -> ~0.5ms; memory ~ -30%",
         "overrides": {"serve_tp_only": True, "serve_params_dtype": "bfloat16"}},
        {"hypothesis": "with weights resident, KV-cache reads dominate decode "
                       "HBM traffic; fp8 KV halves them at negligible decode "
                       "quality cost.",
         "napkin": "KV bytes 2B->1B: memory term ~ -35%",
         "overrides": {"kv_dtype": "float8_e4m3fn"}},
    ]),
]


def run(batch: int | None = None, layers: int | None = None, device="cuda",
        calls: int = 3, out_path: str = "results/hillclimb_torch.json") -> list:
    out: list = []
    for arch, shape, steps in CELLS:
        iterate(arch, shape, steps, out, batch=batch, layers=layers,
                device=device, calls=calls)
    path = pathlib.Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"\nwrote {path}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None,
                    help="every run's batch (default: one chip's of 16x16)")
    ap.add_argument("--layers", type=int, default=None,
                    help="every run's depth (default: the config's)")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(batch=args.batch, layers=args.layers, device=args.device,
        calls=args.calls)


if __name__ == "__main__":
    main()
