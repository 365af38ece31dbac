"""Re-derive dry-run metrics from saved op listings with the current analyzer.

Port of `repro/analysis/reprocess.py`. The dry run stores
<arch>__<shape>__<pod>[<variant>].ops.json.gz next to its JSON; this tool
re-runs `repro_torch.analysis.ops` over them (analyzer improvements need
no new abstract pass).

  PYTHONPATH=src python -m repro_torch.analysis.reprocess --dir results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import pathlib

SUFFIX = ".ops.json.gz"


def parse_tag(filename: str) -> tuple[str, str, bool, str]:
    """(arch, shape, multi_pod, variant) of a listing's file name."""
    arch, shape, pod, *rest = filename[: -len(SUFFIX)].split("__")
    variant = "".join(f"__{p}" for p in rest) or "baseline"
    return arch, shape, pod == "pod2", variant


def reprocess(directory: str) -> int:
    """Update every cell of ``directory``'s dryrun_results.json that has a
    listing there; returns how many were updated."""
    from repro_torch.analysis.ops import collective_bytes_from_ops, load_listing

    d = pathlib.Path(directory)
    results_path = d / "dryrun_results.json"
    results = json.loads(results_path.read_text()) if results_path.exists() else []
    by_key = {(r["arch"], r["shape"], r["multi_pod"], r["variant"]): r
              for r in results}
    n = 0
    for f in sorted(d.glob(f"*{SUFFIX}")):
        r = by_key.get(parse_tag(f.name))
        if r is None:
            continue
        coll = collective_bytes_from_ops(load_listing(f))
        r["flops"] = float(coll["dot_flops"])
        r["bytes_accessed"] = float(coll["memory_bytes"])
        r["collective_bytes"] = coll
        n += 1
        print(f"reprocessed {r['arch']} x {r['shape']} ({f.name}): "
              f"flops={r['flops']:.3e} mem={r['bytes_accessed']:.3e} "
              f"coll={coll['total_bytes']:.3e}")
    results_path.write_text(json.dumps(results, indent=1))
    print(f"updated {n} cells in {results_path}")
    return n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args()
    reprocess(args.dir)


if __name__ == "__main__":
    main()
