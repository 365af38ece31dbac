"""Port of `repro/core/registry.py`: `make_cluster(name, config)`.

The port registers one backend so far:

  nezha-vectorized   `VectorizedNezhaCluster` -- the fused DOM engine on
                     ``VectorizedConfig.device`` (the card by default)

Config promotion: pass a `VectorizedConfig`, a bare `CommonConfig` (its
shared fields are copied), or None (defaults). Extra keyword arguments go
to the cluster constructor.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, Optional

from repro_torch.core.cluster import Cluster, CommonConfig
from repro_torch.core.vectorized_cluster import (
    VectorizedConfig,
    VectorizedNezhaCluster,
)


@dataclass(frozen=True)
class ClusterEntry:
    name: str
    config_cls: type
    factory: Callable[..., Cluster]


_REGISTRY: dict[str, ClusterEntry] = {
    "nezha-vectorized": ClusterEntry("nezha-vectorized", VectorizedConfig,
                                     VectorizedNezhaCluster),
}


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
        # Promote: copy ONLY the CommonConfig-declared fields.
        kw = {f.name: getattr(config, f.name) for f in fields(CommonConfig)}
        return config_cls(**kw)
    raise TypeError(
        f"expected {config_cls.__name__} or CommonConfig, got {type(config).__name__}")


def make_cluster(name: str, config: Optional[CommonConfig] = None,
                 **kw) -> Cluster:
    """Construct a registered cluster behind the unified `Cluster` API."""
    entry = _entry(name)
    return entry.factory(_coerce_config(config, entry.config_cls), **kw)


__all__ = ["make_cluster", "available_clusters", "config_class",
           "ClusterEntry"]
