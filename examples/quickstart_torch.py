"""Quickstart on the PyTorch/CUDA port: the three layers in one script.

1. DOM + Nezha consensus on a simulated cloud fabric, the protocol
   registry (every backend under one config and one workload), and the
   declarative Scenario API -- the vectorized backend on the device.
2. A tiny LM trained for a few steps on the device with the fault-tolerant
   trainer (checkpoints commit through the Nezha-replicated metadata log).
3. The CUDA flash-attention kernel checked against the dense oracle.

The port of examples/quickstart.py. The event-driven backends run on the
host; the vectorized backend, the trainer and the kernel run on
``--device`` (the card unless the caller asks for the CPU, where the
kernels' plain versions run).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import tempfile
from dataclasses import fields

import numpy as np


def demo_consensus():
    from repro_torch.core import ClusterConfig, make_cluster

    print("== 1. Nezha consensus on a simulated cloud zone ==")
    cfg = ClusterConfig(f=1, n_proxies=1, n_clients=4, seed=0)
    cluster = make_cluster("nezha", cfg)

    def keep_going(cid, rid):
        if rid < 99:
            cluster.submit(cid, keys=(cid,))

    cluster.on_commit = keep_going
    cluster.start()
    for cid in range(cluster.n_clients):
        cluster.submit(cid, keys=(cid,))
    cluster.run_for(1.0)
    s = cluster.summary()
    print(f"   committed {s['committed']}/400 requests, "
          f"median latency {s['median_latency']*1e6:.0f}us, "
          f"fast-path ratio {s['fast_commit_ratio']:.0%}")
    # crash the leader; the cluster elects a new one and keeps going
    cluster.crash(0)
    for c in cluster.clients:
        c.next_request_id = 0
        c.records.clear()
    for cid in range(cluster.n_clients):
        cluster.submit(cid, keys=(cid,))
    cluster.run_for(1.5)
    s = cluster.summary()
    print(f"   after leader crash: committed {s['committed']}/400, "
          f"new leader = replica {cluster.leader_id}")


def demo_protocol_zoo(device="cuda"):
    """Every registered backend under one config and one workload; the
    backends with a device run on ``device``."""
    from repro_torch.core import (
        CommonConfig,
        available_clusters,
        config_class,
        make_cluster,
    )
    from repro_torch.sim.workload import Workload, WorkloadDriver

    print("== 1b. one config, one workload, every protocol ==")
    cfg = CommonConfig(f=1, n_clients=4, seed=0)
    common = {f.name: getattr(cfg, f.name) for f in fields(CommonConfig)}
    w = Workload(mode="open", rate_per_client=1000, duration=0.1)
    for name in available_clusters():
        cls = config_class(name)
        # the shared config as `make_cluster` promotes it, on ``device``
        # where the backend has one
        on = (cls(**common, device=device)
              if "device" in {f.name for f in fields(cls)} else cfg)
        s = WorkloadDriver(w).run(make_cluster(name, on))
        print(f"   {name:18s} [{s['backend']:10s}] committed={s['committed']:4d} "
              f"median={s['median_latency']*1e6:7.1f}us "
              f"fast-path={s['fast_commit_ratio']:.0%}")


def demo_scenarios(device="cuda"):
    from repro_torch.sim.scenario import available_scenarios, run_scenario

    print("== 1c. declarative scenarios: environment + faults + workload ==")
    # A full paper experiment is two lines: pick a cataloged scenario, run it
    # on any backend (here: a leader crash mid-run on the vectorized backend,
    # on the device).
    result = run_scenario("nezha-vectorized", "leader-crash", device=device)
    print(f"   leader-crash: committed {result.committed}/{result.n_requests}, "
          f"view changes {result.view_changes}, "
          f"median {result.median_latency*1e6:.0f}us")
    result = run_scenario("nezha", "clock-skew-proxy")
    print(f"   clock-skew-proxy (event backend): "
          f"median {result.median_latency*1e6:.0f}us, "
          f"fast-path {result.fast_commit_ratio:.0%}")
    print(f"   catalog: {', '.join(available_scenarios())}")


def demo_training(device="cuda", ckpt_dir=None):
    """The smoke tinyllama trained 8 steps on ``device``; checkpoints go to
    ``ckpt_dir`` (a temporary directory, removed after, when None)."""
    from repro_torch.launch.train import Trainer, TrainerConfig

    print("== 2. tiny-LM training with Nezha-coordinated checkpoints ==")
    with tempfile.TemporaryDirectory() as tmp:
        t = Trainer(TrainerConfig(arch="tinyllama-1.1b", smoke=True, steps=8,
                                  batch=4, seq=64,
                                  ckpt_dir=ckpt_dir or tmp, ckpt_every=4,
                                  device=device))
        hist = t.run()
    print(f"   loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over {len(hist)} steps")
    print(f"   metadata-log fast-commit ratio: {t.log.fast_commit_ratio:.0%}")
    return hist


def demo_kernel(device="cuda"):
    """`flash_attention` on ``device`` (the kernel on the card, its plain
    version on the CPU) against the dense oracle, in float32."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.kernels.ref import flash_attention_ref

    dev = resolve_device(device)
    print(f"== 3. flash-attention kernel vs oracle ({dev.type}) ==")
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(0, 0.5, shape), dtype=torch.float32,
                               device=dev)
               for shape in ((1, 128, 4, 32), (1, 128, 2, 32),
                             (1, 128, 2, 32)))
    out = flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    err = float((out - ref).abs().max().cpu())
    print(f"   max |kernel - oracle| = {err:.2e}")
    if not err <= 2e-5:             # the reference's float32 kernel tolerance
        raise RuntimeError(f"flash_attention is off the oracle by {err}")
    return err


def main(device="cuda") -> None:
    demo_consensus()
    demo_protocol_zoo(device)
    demo_scenarios(device)
    demo_training(device)
    demo_kernel(device)
    print("quickstart OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
