"""Reading a traced window: the device's busy time, each kernel's time and
the idle gaps, from torch.profiler's trace (CUPTI on the card).

The harness marks its own steps with ``record_function`` spans named
``bench.generate``, ``bench.submit`` and ``bench.run_for``. The
``generate`` spans (the benchmark's own generator, between the system's
calls) are cut out of the window, as they are out of ``commits_per_s``'s;
an idle gap of the device in what is left is named by the span that holds
its midpoint (``harness`` when none does).
"""
from __future__ import annotations

import numpy as np

SPANS = ("bench.generate", "bench.submit", "bench.run_for")


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every traced event, in ns
    from the first event's start (integers until then: an epoch-based ns
    count is beyond float64's exact range)."""
    raw = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).split(".")[-1].upper()
        if hasattr(e, "start_ns"):
            start = int(e.start_ns())
        else:
            start = int(e.start_us()) * 1000
        if hasattr(e, "duration_ns"):
            dur = int(e.duration_ns())
        else:
            dur = int(e.duration_us()) * 1000
        raw.append((e.name(), dev == "CUDA", start, dur))
    base = min((r[2] for r in raw), default=0)
    return [(n, d, float(s - base), float(s - base + du))
            for n, d, s, du in raw]


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge [start, end) rows into disjoint sorted intervals."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    starts = iv[new, 0]
    stops = np.r_[ends[np.flatnonzero(new)[1:] - 1], ends[-1]]
    return np.stack([starts, stops], axis=1)


def _length(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum())


def read(prof) -> dict:
    """Records of the traced window, the generator cut out: ``busy_s``,
    ``kernels`` [(name, seconds)], ``device_ops`` and ``idle_gaps`` (the
    ten largest), ``traced_window_s``."""
    ev = _events(prof)
    spans = [(n, s, e) for n, dev, s, e in ev if not dev and n in SPANS]
    # the spans' own device-side copies (user annotations) are not work
    dev = [(n, s, e) for n, d, s, e in ev if d and not n.startswith("bench.")]
    if not spans:
        return {}
    w0 = min(s for _, s, _ in spans)
    w1 = max(e for _, _, e in spans)
    iv = np.asarray([(max(s, w0), min(e, w1)) for _, s, e in dev
                     if e > w0 and s < w1], float).reshape(-1, 2)
    gen = np.asarray([(s, e) for n, s, e in spans if n == "bench.generate"],
                     float).reshape(-1, 2)
    # device work or the generator; busy time = its length less the
    # generator's
    busy = _union(np.concatenate([iv, gen]))
    gen_s = float(_length(_union(gen))) * 1e-9
    busy_s = float(_length(busy)) * 1e-9 - gen_s
    kernels: dict[str, float] = {}
    for n, s, e in dev:
        if e > w0 and s < w1:
            kernels[n] = kernels.get(n, 0.0) + (e - s) * 1e-9
    edges = np.r_[w0, busy.ravel(), w1].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    sp = np.asarray([(s, e) for _, s, e in spans], float).reshape(-1, 2)
    names = [n for n, _, _ in spans]
    named = []
    for a, b in gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:10]:
        mid = 0.5 * (a + b)
        hit = np.flatnonzero((sp[:, 0] <= mid) & (mid < sp[:, 1]))
        label = names[hit[0]].split(".", 1)[1] if hit.size else "harness"
        named.append([label, float(b - a) * 1e-9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s,
            "traced_window_s": float(w1 - w0) * 1e-9 - gen_s,
            "kernels": kernels,
            "device_ops": [[n[:96], s] for n, s in top],
            "idle_gaps": named}


__all__ = ["read", "SPANS"]
