"""Production and host meshes.

Port of `repro/launch/mesh.py`. Single pod: 16x16 = 256 chips, axes (data,
model). Multi-pod: 2x16x16 = 512 chips, axes (pod, data, model) -- the
"pod" axis carries the slow inter-pod links; the sharding rules put only
DP/FSDP traffic on it.

The production meshes are `AbstractMesh`es: axis names and sizes, no
devices. The dry run reads them for the sharding rules' per-device shapes
and the per-chip batch; the reference lowers its programs on a 512-device
host mesh for the same purpose. `make_host_mesh` builds a
`torch.distributed` `DeviceMesh` over the local cards ((1, 1) on one
H100). Nothing here runs when the module is imported.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def _ensure_process_group(device: str = "cuda") -> None:
    """Start a one-rank process group when none exists: NCCL for CUDA
    tensors (with gloo beside it for CPU tensors) on ``cuda``, gloo on
    ``cpu``; the rendezvous is a `FileStore` in a new temporary
    directory."""
    if dist.is_initialized():
        return
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu' for gloo")
    if kind == "cuda":
        torch.cuda.set_device(0)     # the communicator's card, chosen first
    path = os.path.join(tempfile.mkdtemp(prefix="repro_pg_"), "store")
    store = dist.FileStore(path, 1)
    backend = "cpu:gloo,cuda:nccl" if kind == "cuda" else "gloo"
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_host_mesh(*, data: int = 1, model: int = 1, device: str = "cuda"):
    """(data, model) `DeviceMesh` over however many ranks the process group
    has (the local cards), started as one rank when there is none."""
    from torch.distributed.device_mesh import init_device_mesh

    _ensure_process_group(device)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


__all__ = ["make_production_mesh", "make_host_mesh"]
