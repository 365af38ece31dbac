"""Port of `repro/core/registry.py`: `make_cluster(name, config)` for
every protocol and backend.

Registered names
----------------
  nezha              exact event-driven Nezha (proxied, S5), on the host
  nezha-nonproxy     Nezha-Non-Proxy (proxy logic on the client, S9.7)
  nezha-vectorized   `VectorizedNezhaCluster` -- the fused DOM engine on
                     ``VectorizedConfig.device`` (the card by default)
  nezha-sharded      `ShardedNezhaCluster` -- G such groups over one key
                     space (`ShardedConfig.groups`), cross-group multi-key
                     ops at one pre-stamped global deadline; with
                     ``vmap_groups=True`` all groups' epochs run as one
                     batched call of the epoch body
  multipaxos, raft, fastpaxos, nopaxos, nopaxos-optim, domino,
  toq-epaxos, unreplicated          -- the S9/S10 baselines, on the host

The reference's tier-pinned names (``nezha-vectorized-jit``,
``nezha-vectorized-pallas``) have no counterpart: the port's vectorized
backend picks its device, not a compute tier.

Config promotion: pass the backend's config class, a bare `CommonConfig`
(its shared fields are copied), or None (defaults). Extra keyword arguments
go to the cluster constructor (e.g. ``sm_factory=`` for the Nezha event
backends, ``percentile=`` for Domino).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, Optional

from repro_torch.core.baselines import PROTOCOLS, BaselineConfig
from repro_torch.core.cluster import Cluster, CommonConfig
from repro_torch.core.protocol import ClusterConfig, NezhaCluster
from repro_torch.core.sharded import ShardedConfig, ShardedNezhaCluster
from repro_torch.core.vectorized_cluster import (
    VectorizedConfig,
    VectorizedNezhaCluster,
)


@dataclass(frozen=True)
class ClusterEntry:
    name: str
    config_cls: type
    factory: Callable[..., Cluster]


_REGISTRY: dict[str, ClusterEntry] = {}


def register_cluster(name: str, config_cls: type,
                     factory: Callable[..., Cluster]) -> None:
    if name in _REGISTRY:
        raise ValueError(f"cluster {name!r} already registered")
    _REGISTRY[name] = ClusterEntry(name, config_cls, factory)


def available_clusters() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def config_class(name: str) -> type:
    """The config dataclass a registered cluster is constructed from --
    the scenario layer builds environment-specific configs against it."""
    return _entry(name).config_cls


def _entry(name: str) -> ClusterEntry:
    entry = _REGISTRY.get(name)
    if entry is None:
        raise KeyError(
            f"unknown cluster {name!r}; available: {', '.join(_REGISTRY)}")
    return entry


def _coerce_config(config: Optional[CommonConfig], config_cls: type):
    if config is None:
        return config_cls()
    if isinstance(config, config_cls):
        return config
    if isinstance(config, CommonConfig):
        # Promote: copy ONLY the CommonConfig-declared fields, so
        # protocol-specific calibration (e.g. the baselines' replica_cpu)
        # never leaks across config families.
        kw = {f.name: getattr(config, f.name) for f in fields(CommonConfig)}
        return config_cls(**kw)
    raise TypeError(
        f"expected {config_cls.__name__} or CommonConfig, got {type(config).__name__}")


def make_cluster(name: str, config: Optional[CommonConfig] = None, *,
                 scenario=None, **kw) -> Cluster:
    """Construct a registered cluster behind the unified `Cluster` API.

    ``scenario`` (a `repro_torch.sim.scenario.Scenario` or cataloged name)
    builds the config from the scenario's environment and overrides
    (`build_config`); it configures the cluster only -- `run_scenario`
    also schedules the scenario's faults and drives its workload."""
    entry = _entry(name)
    if scenario is not None:
        if config is not None:
            raise TypeError("pass either config or scenario, not both")
        from repro_torch.sim.scenario import build_config

        config = build_config(name, scenario)
    return entry.factory(_coerce_config(config, entry.config_cls), **kw)


def _make_nonproxy(cfg: ClusterConfig, **kw) -> NezhaCluster:
    if not cfg.co_locate_proxies:
        cfg = replace(cfg, co_locate_proxies=True)
    return NezhaCluster(cfg, **kw)


register_cluster("nezha", ClusterConfig, NezhaCluster)
register_cluster("nezha-nonproxy", ClusterConfig, _make_nonproxy)
register_cluster("nezha-vectorized", VectorizedConfig, VectorizedNezhaCluster)
register_cluster("nezha-sharded", ShardedConfig, ShardedNezhaCluster)
for _name, _cls in PROTOCOLS.items():
    register_cluster(_name, BaselineConfig, _cls)


__all__ = ["make_cluster", "register_cluster", "available_clusters",
           "config_class", "ClusterEntry"]
