"""Port of the fault-target selectors of `repro/sim/scenario.py`.

`VectorizedNezhaCluster.schedule_fault` resolves event selectors through
these two helpers; the scenario catalog itself is not ported yet.
"""
from __future__ import annotations

import numpy as np


def _link_nodes(sel, n_replicas: int, n_proxies: int) -> tuple[tuple, tuple]:
    """Resolve a gray-link endpoint selector to (replica_ids, proxy_ids).

    Range-checked here (schedule/validation time) like `_clock_targets`:
    a bad endpoint must fail loudly, not silently gray out a neighbor."""
    if isinstance(sel, (int, np.integer)):
        sel = f"replica:{int(sel)}"
    if sel == "*":
        return tuple(range(n_replicas)), tuple(range(n_proxies))
    if sel == "replicas":
        return tuple(range(n_replicas)), ()
    if sel == "proxies":
        return (), tuple(range(n_proxies))
    role, _, idx = str(sel).partition(":")
    if role in ("replica", "proxy") and idx.isdigit():
        n = n_replicas if role == "replica" else n_proxies
        if int(idx) >= n:
            raise ValueError(
                f"gray-link endpoint {sel!r} out of range: "
                f"cluster has {n} {role} node(s)")
        return ((int(idx),), ()) if role == "replica" else ((), (int(idx),))
    raise ValueError(
        f"bad gray-link endpoint {sel!r}; expected 'replica:<i>', "
        "'proxy:<i>', 'replicas', 'proxies' or '*'")


def _clock_targets(who: str, n_replicas: int, n_proxies: int) -> list[tuple[str, int]]:
    if who == "leader":
        return [("replica", 0)]
    if who == "replicas":
        return [("replica", i) for i in range(n_replicas)]
    if who == "proxies":
        return [("proxy", i) for i in range(n_proxies)]
    role, _, idx = who.partition(":")
    if role in ("replica", "proxy") and idx.isdigit():
        # Range-checked here, where the cluster's shape is known: an
        # out-of-range index must fail at schedule time on EVERY backend,
        # not silently fault a neighboring node's clock mid-run.
        n = n_replicas if role == "replica" else n_proxies
        if int(idx) >= n:
            raise ValueError(
                f"clock-fault selector {who!r} out of range: "
                f"cluster has {n} {role} node(s)")
        return [(role, int(idx))]
    raise ValueError(
        f"bad clock-fault selector {who!r}; expected 'leader', 'replicas', "
        "'proxies', 'replica:<i>' or 'proxy:<i>'")


__all__ = ["_link_nodes", "_clock_targets"]
