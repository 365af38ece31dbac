"""The system under test, built from a deployment file, and what it
produced, read through its public results.

The cluster comes from ``repro_torch.core.make_cluster`` with the
deployment's backend; the results are its ``summary()``, its commit trace
(`repro_torch.sim.trace.CommitTrace.from_cluster`: the synced log and every
client-visible commit), each group's completed view changes and the
speculative tails of its replica logs, as the timed window left them and
after the drain.
"""
from __future__ import annotations

import numpy as np


def make(conf: dict, n_clients: int, seed: int, device: str):
    from repro_torch.core import make_cluster
    from repro_torch.core.clock import ClockParams
    from repro_torch.core.dom import DomParams
    from repro_torch.core.sharded import ShardedConfig
    from repro_torch.core.vectorized_cluster import VectorizedConfig
    from repro_torch.sim.network import NetworkParams

    kw = dict(
        f=int(conf["f"]), n_clients=int(n_clients), seed=int(seed),
        net=NetworkParams(**conf["net"]),
        clock=ClockParams(residual_sigma=float(conf["clock_residual_sigma"])),
        client_timeout=float(conf["client_timeout"]),
        n_proxies=int(conf["n_proxies"]),
        dom=DomParams(**conf["dom"]),
        commutative=bool(conf["commutative"]),
        leader_batch_delay=float(conf["leader_batch_delay"]),
        device=device,
        epoch_duration=float(conf["epoch_duration"]),
        epochs_per_dispatch=int(conf["epochs_per_dispatch"]),
        heartbeat_timeout=float(conf["heartbeat_timeout"]),
        viewchange_resend=float(conf["viewchange_resend"]),
        max_retries=int(conf["max_retries"]))
    backend = conf["backend"]
    if int(conf["replicas"]) != 2 * int(conf["f"]) + 1:
        raise ValueError(f"replicas {conf['replicas']} is not 2f + 1")
    if backend == "nezha-vectorized" and int(conf["groups"]) != 1:
        raise ValueError("nezha-vectorized runs one group")
    if backend == "nezha-sharded":
        cfg = ShardedConfig(
            groups=int(conf["groups"]),
            group_seed_stride=int(conf["group_seed_stride"]),
            multiop_margin=float(conf["multiop_margin"]),
            vmap_groups=bool(conf["vmap_groups"]), **kw)
    elif backend == "nezha-vectorized":
        cfg = VectorizedConfig(**kw)
    else:
        raise ValueError(f"no deployment of backend {backend!r}")
    return make_cluster(backend, cfg)


def groups_of(cl) -> list:
    return list(getattr(cl, "groups", [cl]))


def spec_tails(cl) -> list[dict]:
    """Each group's speculative tail: the admitted, uncommitted entries of
    its replica logs, with the replicas that admitted each."""
    out = []
    for grp in groups_of(cl):
        logs = grp.engine.logs
        out.append({"deadline": logs.spec_deadline.copy(),
                    "cid": logs.spec_cid.copy(),
                    "rid": logs.spec_rid.copy(),
                    "kcls": logs.spec_kcls.copy(),
                    "admitted": logs.spec_admitted.copy()})
    return out


def observation(cl, spec_window: list) -> dict:
    """The port's results in the comparison's common form; ``spec_window``
    is `spec_tails` as the timed window left them."""
    from repro_torch.sim.trace import CommitTrace

    tr = CommitTrace.from_cluster(cl)
    traces = tr.groups if hasattr(tr, "groups") else [tr]
    out = {"groups": [], "summary": cl.summary(),
           "multiops": {u: (tuple(m["groups"]), float(m["deadline"]))
                        for u, m in getattr(tr, "multiops", {}).items()}}
    for grp, gt, spec, spec_w in zip(groups_of(cl), traces, spec_tails(cl),
                                     spec_window):
        out["groups"].append({
            "log": {c: np.asarray(v) for c, v in gt.log.items()},
            "commits": {c: np.asarray(v) for c, v in gt.commits.items()},
            "view_changes": list(grp.view_change_events),
            "spec": spec, "spec_window": spec_w,
        })
    return out


def committed_count(cl) -> int:
    return int(cl.summary()["committed"])


__all__ = ["make", "observation", "spec_tails", "groups_of", "committed_count"]
