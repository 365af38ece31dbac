"""S10 application #1 on the PyTorch port: a Redis-like KV store replicated
with Nezha.

YCSB-A-style workload (50% HGETALL-reads / 50% HMSET-writes over 1000 keys,
40 closed-loop clients), compared with an unreplicated server -- the
paper's "within 5.9% of unreplicated" experiment at simulation scale.

The port of examples/replicated_kv_store.py, on the port's event-driven
backends. Those run on the host: ``--device`` is checked (the card unless
the caller asks for the CPU) and used by nothing here.

Run:  PYTHONPATH=src python examples/replicated_kv_store_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import ClusterConfig, OpType, make_cluster
from repro_torch.core.baselines import BaselineConfig
from repro_torch.core.replica import KVStore
from repro_torch.kernels.ops import resolve_device
from repro_torch.sim.workload import zipf_key

DURATION = 0.3
N_CLIENTS = 40
EXEC = 18e-6         # HMSET/HGETALL service time (Redis ~55K ops/s ceiling)
N_KEYS = 1000


def run_unreplicated() -> dict:
    from repro_torch.sim.transport import CpuParams

    # identical server hardware as a Nezha replica (apples-to-apples)
    cl = make_cluster("unreplicated", BaselineConfig(
        f=1, n_clients=N_CLIENTS, exec_cost=EXEC, seed=0,
        replica_cpu=CpuParams(send_cost=0.45e-6, recv_cost=1.05e-6, threads=2.0)))
    rng = np.random.default_rng(0)

    def go(cid, rid):
        if cl.now < DURATION:
            op = OpType.READ if rng.random() < 0.5 else OpType.WRITE
            cl.submit(cid, keys=(zipf_key(rng, N_KEYS, 0.99),), op=op)

    cl.on_commit = go
    cl.start()
    for cid in range(N_CLIENTS):
        cl.submit(cid, keys=(zipf_key(rng, N_KEYS, 0.99),))
    cl.run_for(DURATION + 0.05)
    return cl.summary() | {"throughput": cl.summary()["committed"] / DURATION}


def run_nezha() -> dict:
    cfg = ClusterConfig(f=1, n_proxies=3, n_clients=N_CLIENTS, exec_cost=EXEC, seed=0)
    cl = make_cluster("nezha", cfg, sm_factory=KVStore)
    rng = np.random.default_rng(0)

    def go(cid, rid):
        if cl.now < DURATION:
            k = zipf_key(rng, N_KEYS, 0.99)
            if rng.random() < 0.5:
                cl.submit(cid, command=("GET", k), op=OpType.READ, keys=(k,))
            else:
                cl.submit(cid, command=("SET", k, rid), op=OpType.WRITE, keys=(k,))

    cl.on_commit = go
    cl.start()
    for cid in range(N_CLIENTS):
        k = zipf_key(rng, N_KEYS, 0.99)
        cl.submit(cid, command=("SET", k, 0), keys=(k,))
    cl.run_for(DURATION + 0.05)
    s = cl.summary()
    s["throughput"] = s["committed"] / DURATION
    return s


def main(device="cuda") -> tuple[dict, dict]:
    resolve_device(device)
    u = run_unreplicated()
    n = run_nezha()
    print(f"unreplicated : {u['throughput']:8.0f} req/s  "
          f"median {u.get('median_latency', 0)*1e6:6.1f}us")
    print(f"nezha (2f+1=3): {n['throughput']:8.0f} req/s  "
          f"median {n.get('median_latency', 0)*1e6:6.1f}us  "
          f"fast-path {n['fast_commit_ratio']:.0%}")
    print(f"replication cost: {(1 - n['throughput']/u['throughput'])*100:.1f}% "
          f"throughput (paper: 5.9%)")
    return u, n


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
