"""The one traffic generator: a cell's request stream and fault schedule
from its traffic file and ``--seed``, in bulk with numpy.

Simulated time is cut into spans: span 0 is the warm-up
(``warmup_epochs``), span k >= 1 the k-th chunk of the window
(``chunk_epochs``). Each span's requests come from their own generator,
seeded with (seed, span), so a seed gives the same requests whatever the
wall clock lets a run reach:

  arrivals  open loop, Poisson: each client's count in the span is
            Poisson(rate x span), its times uniform over the span;
  keys      ``zipf`` (YCSB's inverse CDF, x = N u^(1 / (1 - theta))) or
            ``uniform`` over the key space; with probability
            ``multikey_share`` a request carries ``multikey_span``
            distinct keys;
  ops       a read with probability ``read_share``, else a write;
  faults    every ``period_s`` from time 0, each event at its offset;
            ``"leader"`` names the replica that leads after one view change
            a period (view k in period k: replica k mod 2f+1).

A `Block` is what the harness submits and what the reference replays.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Block:
    """One span's calls, in the order they are made."""

    t_lo: float
    t_hi: float
    t: np.ndarray                  # [n] submit times, sorted
    cid: np.ndarray                # [n] client ids
    keys: list                     # [n] key tuples
    read: np.ndarray               # [n] bool
    faults: list = field(default_factory=list)  # (t, kind, replica)


class Plan:
    def __init__(self, traffic: dict, conf: dict, seed: int):
        self.tr = traffic
        self.seed = int(seed)
        self.epoch = float(conf["epoch_duration"])
        self.replicas = 2 * int(conf["f"]) + 1
        self.clients = int(traffic["clients"])
        self.rate = float(traffic["rate_per_client"])
        self.warm_s = int(traffic["warmup_epochs"]) * self.epoch
        self.chunk_s = int(traffic["chunk_epochs"]) * self.epoch
        if traffic.get("loop", "open") != "open" \
                or traffic.get("arrivals", "poisson") != "poisson":
            raise ValueError("the generator makes open-loop Poisson traffic")

    def span_bounds(self, span: int) -> tuple[float, float]:
        if span == 0:
            return 0.0, self.warm_s
        lo = self.warm_s + (span - 1) * self.chunk_s
        return lo, lo + self.chunk_s

    def _keys(self, rng, n: int) -> np.ndarray:
        k = self.tr["keys"]
        space = int(k["space"])
        if k["dist"] == "uniform":
            return rng.integers(0, space, n)
        if k["dist"] == "zipf":
            theta = min(float(k["theta"]), 0.999)
            x = space * rng.random(n) ** (1.0 / (1.0 - theta))
            return np.minimum(x.astype(np.int64), space - 1)
        raise ValueError(f"unknown key distribution {k['dist']!r}")

    def block(self, span: int) -> Block:
        lo, hi = self.span_bounds(span)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, span]))
        counts = rng.poisson(self.rate * (hi - lo), self.clients)
        n = int(counts.sum())
        t = rng.uniform(lo, hi, n)
        cid = np.repeat(np.arange(self.clients), counts)
        order = np.argsort(t, kind="stable")
        t, cid = t[order], cid[order]
        first = self._keys(rng, n)
        read = rng.random(n) < float(self.tr.get("read_share", 0.0))
        keys = [(int(k),) for k in first.tolist()]
        share = float(self.tr.get("multikey_share", 0.0))
        span_k = int(self.tr.get("multikey_span", 1))
        if share > 0.0 and span_k >= 2:
            multi = np.flatnonzero(rng.random(n) < share)
            extra = self._keys(rng, multi.size * (span_k - 1)).reshape(
                multi.size, span_k - 1)
            for row, i in enumerate(multi.tolist()):
                ks = [keys[i][0]]
                for k in extra[row].tolist():
                    while k in ks:          # distinct keys, as a client asks
                        k = int(self._keys(rng, 1)[0])
                    ks.append(k)
                keys[i] = tuple(ks)
        return Block(lo, hi, t, cid, keys, read, self._faults(lo, hi))

    def _faults(self, lo: float, hi: float) -> list:
        f = self.tr.get("faults")
        if not f:
            return []
        period = float(f["period_s"])
        out = []
        k = int(np.floor(lo / period)) - 1
        while k * period < hi:
            if k >= 0:
                for ev in f["events"]:
                    t = k * period + float(ev["at_s"])
                    if lo <= t < hi:
                        who = ev["replica"]
                        r = k % self.replicas if who == "leader" else int(who)
                        out.append((t, ev["kind"], r))
            k += 1
        out.sort(key=lambda e: e[0])
        return out


__all__ = ["Block", "Plan"]
