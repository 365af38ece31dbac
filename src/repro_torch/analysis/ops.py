"""The aten-op listing of a step and its cost analysis.

The port's counterpart of `repro/analysis/hlo.py`. Torch has no HLO; its
"compiled program as text" is the list of aten ops a step dispatches. The
step runs under `FakeTensorMode` (tensors with shapes and dtypes, no
storage) with `OpRecorder`, a `TorchDispatchMode`, recording each op with
its tensor inputs' and outputs' dtypes and shapes. A hand-written kernel
is recorded as the card runs it: one op, ``kernel.<name>``, with the
kernel's own FLOPs and bytes (`repro_torch.kernels.record`); its plain
version's ops, which only give the outputs' shapes there, are not counted.
A kernel's backward is the plain version's, on the card as here.

A listing is a list of entries ``[op, count, inputs, outputs]`` (``op``
as ``aten.mm.default``; inputs and outputs lists of ``[dtype, shape]``),
identical ops merged with their count; a kernel's entry has a fifth
element, ``{"flops": f, "bytes": b}``. A stack of identical layers
repeats the same ops, so `repro_torch.launch.dryrun` records a step at
the least depth (0 layers; 1 for the encoder-decoder) and one layer deeper
in each stack, and keeps the recordings as weighted probes,
``{"probes": [{"weight": w, "ops": listing}, ...]}``: every quantity below
is affine in the depth, and the weighted sum of the probes' analyses is
the full depth's (the counterpart of the HLO's loop trip counts).

`analyze_ops` applies `analyze_hlo`'s rules:
  * dot FLOPs: 2 x output elements x contracted size (mm, bmm, addmm,
    baddbmm, ...); a kernel's own FLOPs (its products);
  * a kernel's memory bytes: its inputs read once, its outputs written
    once;
  * collective bytes (c10d all-reduce / all-gather / reduce-scatter /
    all-to-all / send-recv): output bytes;
  * memory bytes, the HBM traffic proxy: dot operands + outputs, twice a
    collective's output, plus the outputs of copy, index/gather/embedding,
    scatter, reductions, sort/topk, cat/stack, transpose/permute and
    convolution. Elementwise ops are excluded, as there.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import math
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import record

# op base name -> index of the left operand among its tensor inputs
DOT_LHS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "addbmm": 1,
           "mv": 0, "addmv": 1, "dot": 0, "vdot": 0, "_scaled_mm": 0}
MOVERS = frozenset({
    "copy", "_to_copy", "clone", "index", "index_select", "gather",
    "embedding", "take", "scatter", "scatter_add", "scatter_reduce",
    "index_put", "index_add", "index_copy", "slice_scatter",
    "select_scatter", "sum", "mean", "amax", "amin", "max", "min", "prod",
    "argmax", "argmin", "cumsum", "logsumexp", "_softmax", "_log_softmax",
    "sort", "topk", "cat", "stack", "transpose", "permute", "t",
    "convolution"})
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_KINDS = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
          ("allgather", "all-gather"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"), ("send", "collective-permute"),
          ("recv", "collective-permute"))


def _spec(t: torch.Tensor) -> tuple:
    return (str(t.dtype).removeprefix("torch."), tuple(t.shape))


def _specs(tree) -> tuple:
    return tuple(_spec(t) for t in tree_leaves(tree)
                 if isinstance(t, torch.Tensor))


class OpRecorder(TorchDispatchMode):
    """Counts every aten op dispatched while active, by (op, input specs,
    output specs), and every kernel launch `repro_torch.kernels.record`
    reports, by (op, specs, cost)."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self._muted = 0

    def __enter__(self):
        record.RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        record.RECORDERS.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def muted(self):
        """Ops dispatched inside are not counted."""
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1

    def add_kernel(self, name: str, inputs, outputs, *, flops: int,
                   nbytes: int) -> None:
        self.counts[(f"kernel.{name}", _specs(inputs), _specs(outputs),
                     (int(flops), int(nbytes)))] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim" or self._muted:   # no work, or a kernel's
            return out
        self.counts[(str(func), _specs((args, kwargs or {})), _specs(out),
                     ())] += 1
        return out

    def listing(self) -> list:
        return [[op, n, [[d, list(s)] for d, s in ins],
                 [[d, list(s)] for d, s in outs]]
                + ([{"flops": cost[0], "bytes": cost[1]}] if cost else [])
                for (op, ins, outs, cost), n in self.counts.items()]


def _fake_inputs(tree):
    if isinstance(tree, dict):
        return {k: _fake_inputs(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(_fake_inputs(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fake_inputs(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tuple(tree.shape), dtype=tree.dtype)
    return tree


def record_ops(fn, *args, **kwargs) -> list:
    """The listing of ``fn(*args, **kwargs)`` run under `FakeTensorMode`:
    every tensor among the arguments (meta or real) becomes a fake CPU
    tensor of its shape and dtype; nothing is allocated or computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fargs, fkwargs = _fake_inputs(args), _fake_inputs(kwargs)
        with OpRecorder() as rec:
            fn(*fargs, **fkwargs)
    return rec.listing()


def _bytes(specs) -> int:
    return sum(math.prod(shape) * getattr(torch, dtype).itemsize
               for dtype, shape in specs)


def _names(op: str) -> tuple[str, str]:
    """(namespace, base name): ``aten.copy_.default`` -> ("aten", "copy")."""
    parts = op.split(".")
    return parts[0], parts[1].rstrip("_") if len(parts) > 1 else ""


def _collective_kind(ns: str, base: str):
    if ns not in COLLECTIVE_NAMESPACES:
        return None
    for key, kind in _KINDS:
        if key in base:
            return kind
    return None


def _analyze_listing(listing: list, weight: float, acc: dict) -> None:
    for op, n, ins, outs, *cost in listing:
        k = n * weight
        ns, base = _names(op)
        if ns == "kernel":
            acc["dot_flops"] += cost[0]["flops"] * k
            acc["memory_bytes"] += cost[0]["bytes"] * k
            continue
        if ns == "aten" and base in DOT_LHS:
            lhs = DOT_LHS[base]
            out_n = math.prod(outs[0][1]) if outs else 0
            csize = ins[lhs][1][-1] if len(ins) > lhs and ins[lhs][1] else 1
            acc["dot_flops"] += 2.0 * out_n * csize * k
            acc["memory_bytes"] += (_bytes(outs) + _bytes(ins[lhs:lhs + 2])) * k
            continue
        kind = _collective_kind(ns, base)
        if kind is not None:
            b = _bytes(outs)
            acc["coll_bytes"][kind] += b * k
            acc["coll_counts"][kind] += k
            acc["memory_bytes"] += 2 * b * k   # read + write through HBM
            continue
        if ns == "aten" and base in MOVERS:
            acc["memory_bytes"] += _bytes(outs) * k


def _probes(listing) -> list:
    if isinstance(listing, dict):
        return [(p["weight"], p["ops"]) for p in listing["probes"]]
    return [(1.0, listing)]


def analyze_ops(listing) -> dict:
    """dot FLOPs, collective bytes and counts by kind, and memory bytes of
    a listing (plain, or weighted probes)."""
    acc = {"dot_flops": 0.0, "memory_bytes": 0.0,
           "coll_bytes": defaultdict(float), "coll_counts": defaultdict(float)}
    for weight, ops in _probes(listing):
        _analyze_listing(ops, weight, acc)
    return {
        "dot_flops": acc["dot_flops"],
        "collective_bytes": {kk: float(v) for kk, v in acc["coll_bytes"].items()},
        "collective_counts": {kk: float(v) for kk, v in acc["coll_counts"].items()},
        "collective_total_bytes": float(sum(acc["coll_bytes"].values())),
        "memory_bytes": acc["memory_bytes"],
    }


def collective_bytes_from_ops(listing) -> dict:
    """`analyze_ops` in the keys `repro.analysis.hlo.collective_bytes_from_hlo`
    gives (the dry run's record)."""
    a = analyze_ops(listing)
    return {"bytes": a["collective_bytes"], "counts": a["collective_counts"],
            "total_bytes": a["collective_total_bytes"],
            "dot_flops": a["dot_flops"], "memory_bytes": a["memory_bytes"]}


def save_listing(path, listing) -> None:
    with gzip.open(path, "wt") as fh:
        json.dump(listing, fh)


def load_listing(path):
    with gzip.open(path, "rt") as fh:
        return json.load(fh)


__all__ = ["OpRecorder", "record_ops", "analyze_ops",
           "collective_bytes_from_ops", "save_listing", "load_listing"]
