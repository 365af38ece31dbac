"""S10 application #2 on the PyTorch port: a CloudEx-style fair-access
exchange with a Nezha-replicated matching engine.

The matching engine is a price-time-priority limit-order book; orders are
DOM-ordered by deadline in synchronized time, which is exactly CloudEx's
fairness mechanism (orders take effect in *send-time* order, not arrival
order) -- here it falls out of the consensus layer for free. Fault tolerance:
kill the leader mid-session; the book survives.

The port of examples/fair_exchange.py, on the port's event-driven `nezha`
backend. It runs on the host: ``--device`` is checked (the card unless the
caller asks for the CPU) and used by nothing here.

Run:  PYTHONPATH=src python examples/fair_exchange_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import ClusterConfig, OpType, make_cluster
from repro_torch.core.replica import StateMachine
from repro_torch.kernels.ops import resolve_device


class MatchingEngine(StateMachine):
    """Price-time-priority book. Command: ("ORDER", side, price, qty)."""

    def __init__(self):
        self.bids: list = []   # (-price, seq, qty)
        self.asks: list = []   # (price, seq, qty)
        self.seq = 0
        self.trades = 0
        self.volume = 0

    def execute(self, command):
        import heapq

        if command[0] != "ORDER":
            return None
        _, side, price, qty = command
        self.seq += 1
        fills = []
        if side == "B":
            while qty > 0 and self.asks and self.asks[0][0] <= price:
                ap, aseq, aqty = heapq.heappop(self.asks)
                take = min(qty, aqty)
                fills.append((ap, take))
                qty -= take
                self.trades += 1
                self.volume += take
                if aqty > take:
                    heapq.heappush(self.asks, (ap, aseq, aqty - take))
            if qty > 0:
                heapq.heappush(self.bids, (-price, self.seq, qty))
        else:
            while qty > 0 and self.bids and -self.bids[0][0] >= price:
                nbp, bseq, bqty = heapq.heappop(self.bids)
                take = min(qty, bqty)
                fills.append((-nbp, take))
                qty -= take
                self.trades += 1
                self.volume += take
                if bqty > take:
                    heapq.heappush(self.bids, (-nbp, bseq, bqty - take))
            if qty > 0:
                heapq.heappush(self.asks, (price, self.seq, qty))
        return tuple(fills)

    def snapshot(self):
        return (list(self.bids), list(self.asks), self.seq, self.trades, self.volume)

    def restore(self, snap):
        self.bids, self.asks, self.seq, self.trades, self.volume = \
            list(snap[0]), list(snap[1]), snap[2], snap[3], snap[4]


def main(device="cuda") -> None:
    resolve_device(device)
    n_participants = 12
    cfg = ClusterConfig(f=1, n_proxies=4, n_clients=n_participants,
                        exec_cost=1.0 / 43100, seed=0)
    cl = make_cluster("nezha", cfg, sm_factory=MatchingEngine)
    rng = np.random.default_rng(0)
    mid = 100.0
    duration = 0.3

    def trade(cid, rid):
        if cl.now < duration:
            side = "B" if rng.random() < 0.5 else "S"
            price = round(mid + rng.normal(0, 2), 1)
            # every symbol keys the same book -> orders are non-commutative
            cl.submit(cid, command=("ORDER", side, price, int(rng.integers(1, 10))),
                      op=OpType.RMW, keys=("book",))

    cl.on_commit = trade
    cl.start()
    for cid in range(cl.n_clients):
        cl.submit(cid, command=("ORDER", "B", mid, 1), op=OpType.RMW, keys=("book",))
    cl.run_for(0.15)
    leader_before = cl.leader_id
    cl.crash(leader_before)                 # kill the matching engine leader
    cl.run_for(duration - 0.15 + 0.3)
    s = cl.summary()
    eng = cl.replicas[cl.leader_id].sm
    print(f"orders committed : {s['committed']} "
          f"(median latency {s['median_latency']*1e6:.0f}us, "
          f"fast-path {s['fast_commit_ratio']:.0%})")
    print(f"leader failover  : replica {leader_before} -> {cl.leader_id} mid-session")
    print(f"book after crash : {eng.trades} trades, volume {eng.volume}, "
          f"{len(eng.bids)} bids / {len(eng.asks)} asks resting")
    # deterministic replay check: a fresh engine fed the committed log agrees
    replay = MatchingEngine()
    for e in cl.replicas[cl.leader_id].synced:
        replay.execute(e.request.command)
    assert (replay.trades, replay.volume) == (eng.trades, eng.volume), "replay divergence"
    print("deterministic replay: OK (book state is a pure function of the log)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
