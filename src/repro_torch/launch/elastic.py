"""Elastic scaling: recompute the mesh + shardings on the surviving device
set and reshard the training state.

Port of `repro/launch/elastic.py`. Flow on a real cluster: the health
monitor detects dead hosts -> a scaling event commits to the Nezha metadata
log (`ReplicatedMetadataLog.record_scaling_event`, so every survivor agrees
on the new world) -> each survivor rebuilds the mesh from the agreed device
list -> state is resharded -> training resumes from the last committed
step.

Here the resharding is real (DTensor `distribute_tensor` with the new
mesh's placements); failure detection is injected by the caller or test.
Devices are the ranks of the process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch.parallel.sharding import distribute, param_shardings


@dataclass
class WorldState:
    n_devices: int
    mesh_shape: tuple
    generation: int = 0


def plan_mesh(n_devices: int, *, model_parallel: int = 1) -> tuple:
    """Largest (data, model) grid that fits the surviving device count."""
    model = min(model_parallel, n_devices)
    while n_devices % model:
        model -= 1
    return (n_devices // model, model)


def remesh(devices, *, model_parallel: int = 1, device_type: str = "cuda"):
    """A (data, model) `DeviceMesh` over the ranks ``devices``."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = plan_mesh(len(devices), model_parallel=model_parallel)
    ranks = torch.as_tensor(list(devices)[: shape[0] * shape[1]]).reshape(
        shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def reshard_state(state, new_mesh, abstract_like=None):
    """Move every tensor of ``state`` (a params tree) onto the new mesh's
    shardings; a DTensor of the old mesh is gathered first."""
    from torch.distributed.tensor import DTensor

    ref = abstract_like if abstract_like is not None else state
    full = tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, state)
    return distribute(full, param_shardings(ref, new_mesh))


def elastic_step(world: WorldState, healthy_devices, log=None,
                 model_parallel: int = 1,
                 device_type: str = "cuda") -> Optional[tuple]:
    """If the healthy set changed, agree on a new world (via the metadata
    log when present) and return (new_world, new_mesh); else None."""
    n = len(healthy_devices)
    if n == world.n_devices:
        return None
    shape = plan_mesh(n, model_parallel=model_parallel)
    new_world = WorldState(n_devices=n, mesh_shape=shape,
                           generation=world.generation + 1)
    if log is not None:
        log.record_scaling_event(step=new_world.generation, n_healthy=n,
                                 mesh_shape=shape)
    mesh = remesh(healthy_devices, model_parallel=model_parallel,
                  device_type=device_type)
    return new_world, mesh


__all__ = ["WorldState", "plan_mesh", "remesh", "reshard_state", "elastic_step"]
