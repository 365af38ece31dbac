"""Three-term roofline analysis of the dry run's results, on one H100.

Port of `repro/analysis/roofline.py` with the card's constants (NVIDIA
H100 SXM data sheet, dense, at the 700 W limit): 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s HBM3, NVLink 450 GB/s a direction (used only where
a listing holds a collective: one card runs none).

The dry run's flops and bytes are those of the step the card ran
(`repro_torch.analysis.ops` over its aten-op listing), so:

    compute term    = flops / PEAK_FLOPS
    memory term     = bytes_accessed / HBM_BW
    collective term = collective_bytes / LINK_BW

MODEL_FLOPS = 6 N D for training (fwd+bwd), 2 N D for inference, with
N = active params for MoE; D = tokens processed by the step (the cell's
global batch, or the card run's ``batch`` and depth when the results give
them). The ratio MODEL_FLOPS / (flops x n_chips) exposes remat recompute
and dispatch overheads. Beside the bound's fraction (useful compute time
over the largest term) stands the measured one: useful compute time over
the card's measured ``step_s``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

PEAK_FLOPS = 989e12        # bf16 FLOP/s, H100 SXM, dense
HBM_BW = 3.35e12           # bytes/s, H100 SXM HBM3
LINK_BW = 450e9            # bytes/s a direction, NVLink 4 (18 links)


def model_flops(arch: str, shape: str, *, batch: Optional[int] = None,
                n_layers: Optional[int] = None) -> float:
    """6 N D (train) or 2 N D (prefill, decode) of the cell; ``batch`` and
    ``n_layers`` replace the shape's global batch and the config's depth."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models.model import count_params

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    sp = SHAPES[shape]
    B = sp.global_batch if batch is None else batch
    n = count_params(cfg, active_only=True)
    if sp.kind == "train":
        return 6.0 * n * sp.seq_len * B
    if sp.kind == "prefill":
        return 2.0 * n * sp.seq_len * B
    # decode: one token per sequence
    return 2.0 * n * B


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    mem_gib_per_dev: float
    step_s: Optional[float] = None      # measured on the card
    peak_gib: Optional[float] = None    # measured on the card

    def step_time(self) -> float:
        """No-overlap upper bound; with perfect overlap it's the max term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """useful compute time / bound step time (the score we hillclimb)."""
        useful_s = self.model_flops / (PEAK_FLOPS * self._chips)
        return useful_s / max(self.step_time(), 1e-30)

    def measured_fraction(self) -> Optional[float]:
        """useful compute time / the measured step time."""
        if self.step_s is None:
            return None
        useful_s = self.model_flops / (PEAK_FLOPS * self._chips)
        return useful_s / max(self.step_s, 1e-30)

    _chips: int = 1


def analyze(results_path: str = "results/dryrun_torch/dryrun_results.json",
            multi_pod: Optional[bool] = False) -> list[RooflineRow]:
    rows = []
    with open(results_path) as fh:
        results = json.load(fh)
    for r in results:
        if r["status"] != "ok":
            continue
        if multi_pod is not None and r["multi_pod"] != multi_pod:
            continue
        n_chips = r["n_chips"]
        compute_s = r["flops"] / PEAK_FLOPS
        memory_s = r["bytes_accessed"] / HBM_BW
        coll_s = r["collective_bytes"]["total_bytes"] / LINK_BW
        terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
        dom = max(terms, key=terms.get)
        mf = model_flops(r["arch"], r["shape"], batch=r.get("batch"),
                         n_layers=r.get("n_layers"))
        total_flops = r["flops"] * n_chips
        mem_gib = sum(r["memory"].values()) / 2**30
        peak = r.get("peak_bytes")
        row = RooflineRow(
            arch=r["arch"], shape=r["shape"],
            mesh="2x16x16" if r["multi_pod"] else "16x16",
            compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
            dominant=dom, model_flops=mf, hlo_flops_total=total_flops,
            useful_ratio=mf / max(total_flops, 1e-30),
            mem_gib_per_dev=mem_gib, step_s=r.get("step_s"),
            peak_gib=None if peak is None else peak / 2**30)
        row._chips = n_chips
        rows.append(row)
    return rows


def _fmt(x, spec: str) -> str:
    return "not measured" if x is None else format(x, spec)


def to_markdown(rows: list[RooflineRow]) -> str:
    out = ["| arch | shape | mesh | compute (s) | memory (s) | collective (s) | dominant | MODEL_FLOPS | useful/op FLOPs | roofline frac | mem GiB/dev | step (s) | measured frac | peak GiB |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r.arch, r.shape)):
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | {r.memory_s:.3e} "
            f"| {r.collective_s:.3e} | **{r.dominant}** | {r.model_flops:.2e} "
            f"| {r.useful_ratio:.2f} | {r.roofline_fraction():.3f} | {r.mem_gib_per_dev:.1f} "
            f"| {_fmt(r.step_s, '.4g')} | {_fmt(r.measured_fraction(), '.3f')} "
            f"| {_fmt(r.peak_gib, '.1f')} |")
    return "\n".join(out)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch/dryrun_results.json")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    rows = analyze(args.results, multi_pod=args.multi_pod)
    print(to_markdown(rows))
    if rows:
        worst = min(rows, key=lambda r: r.roofline_fraction())
        coll = max(rows, key=lambda r: r.collective_s / max(r.step_time(), 1e-30))
        print(f"\nworst roofline fraction : {worst.arch} x {worst.shape} "
              f"({worst.roofline_fraction():.3f})")
        print(f"most collective-bound   : {coll.arch} x {coll.shape} "
              f"({coll.collective_s / max(coll.step_time(),1e-30):.2f} of bound)")


if __name__ == "__main__":
    main()
