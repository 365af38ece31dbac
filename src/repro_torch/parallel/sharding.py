"""Per-architecture sharding rules over the (pod, data, model) mesh.

Port of `repro/parallel/sharding.py`. Scheme (FSDP x TP x EP):
  * weights [in, out]: `out` over "model" (tensor parallel), `in` over
    ("pod","data") (fully sharded / ZeRO-3).
  * projections back to d_model ([out, in] layout like wo / w_down): mirror.
  * MoE expert stacks [E, d, f]: experts over "model" (expert parallelism),
    d over ("pod","data").
  * embeddings / lm_head [V, d]: vocab over "model" (sharded softmax),
    d over ("pod","data").
  * activations: batch over ("pod","data").
  * optimizer state: same spec as its parameter.

Rules are name-based over the param-tree paths so every architecture
(dense/MoE/SSM/hybrid/enc-dec) is covered by one table; stacked [L, ...]
parameters get a leading None.

The rules are pure functions of axis names, axis sizes and leaf shapes. A
spec is a tuple with one entry per tensor dim: None (replicated), an axis
name, or a tuple of axis names (the dim split over their product, the
first the major one); a one-name tuple is written as the name, as
`jax.sharding.PartitionSpec` writes it. Each leaf gets a `NamedSharding`
(its mesh and spec). The mesh is an `AbstractMesh` (names and sizes, no
devices: the production meshes) or a `torch.distributed` `DeviceMesh`, on
which a spec becomes DTensor placements (`placements`, `distribute`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_map

DATA_AXES = ("pod", "data")   # collapsed to just ("data",) on single-pod meshes
MODEL_AXIS = "model"


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh as axis sizes and names only (no devices are touched)."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of an `AbstractMesh` or a `DeviceMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _names(mesh) -> tuple:
    return tuple(_axis_sizes(mesh))


def _entry(axes):
    """A spec entry in canonical form: a one-name tuple is the name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """One leaf's spec on its mesh."""
    mesh: object
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        return shard_shape(shape, self.spec, self.mesh)


def _sharding(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(_entry(a) for a in spec))


def shard_shape(shape, spec, mesh) -> tuple:
    """The per-device local shape of a ``shape`` tensor laid out by
    ``spec`` on ``mesh``: each sharded dim divided by the product of its
    axes' sizes (the rules shard only dims that divide)."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes_of(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {entry} ({n} ways)")
        out[i] //= n
    return tuple(out)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on a `DeviceMesh`: one per mesh dim,
    `Shard(d)` where the mesh axis splits tensor dim d, else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec) if name in _axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def distribute(tree, shardings):
    """Every leaf of ``tree`` as a DTensor laid out by its sharding (a tree
    of `NamedSharding` on `DeviceMesh`es, as the rules return)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda x, s: distribute_tensor(
        x, s.mesh, placements(s.spec, s.mesh)), tree, shardings)


def _fsdp(mesh, dp_only: bool = False):
    names = _names(mesh)
    axes = tuple(a for a in DATA_AXES if a in names)
    if dp_only and MODEL_AXIS in names:
        # Small models: tensor parallelism wastes links on activation
        # all-reduces; fold the model axis into the FSDP/data group instead.
        axes = axes + (MODEL_AXIS,)
    return axes or None


def _size(sizes: dict, axes) -> int:
    return math.prod(sizes[a] for a in _axes_of(axes))


def _spec_for(path: tuple, shape: tuple, mesh, dp_only: bool = False) -> tuple:
    """The spec of one parameter."""
    sizes = _axis_sizes(mesh)
    fsdp = _fsdp(mesh, dp_only)
    name = path[-1]
    stacked = path[0] in ("layers", "enc_layers")
    core = shape[1:] if stacked else shape
    lead = (None,) if stacked else ()
    if dp_only:
        # everything is FSDP-sharded on its largest divisible dim; no TP
        n = _size(sizes, fsdp) if fsdp else 1
        spec = [None] * len(core)
        order = sorted(range(len(core)), key=lambda i: -core[i])
        for i in order:
            if core[i] % n == 0 and n > 1:
                spec[i] = fsdp
                break
        return lead + tuple(spec)

    def ok(dim_size, axes):
        return axes is not None and dim_size % _size(sizes, axes) == 0

    # ---- table ----------------------------------------------------------------
    if name in ("scale", "bias", "out_norm", "dt_bias", "A_log", "D",
                "bq", "bk", "bv", "b_up", "b_down"):
        spec = (None,) * len(core)
    elif name in ("embed", "lm_head"):
        spec = (MODEL_AXIS if ok(core[0], MODEL_AXIS) else None,
                fsdp if ok(core[1], fsdp) else None)
    elif name == "pos_embed":
        spec = (None, fsdp if ok(core[1], fsdp) else None)
    elif name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
        spec = (fsdp if ok(core[0], fsdp) else None,
                MODEL_AXIS if ok(core[1], MODEL_AXIS) else None)
    elif name in ("wo", "w_down", "out_proj"):
        spec = (MODEL_AXIS if ok(core[0], MODEL_AXIS) else None,
                fsdp if ok(core[1], fsdp) else None)
    elif name == "w_router":
        spec = (fsdp if ok(core[0], fsdp) else None, None)
    elif name == "conv_w":
        spec = (None, MODEL_AXIS if ok(core[1], MODEL_AXIS) else None)
    else:
        spec = (None,) * len(core)

    # MoE expert stacks: [E, d, f] -- expert dim over model, d over fsdp.
    if name in ("w_gate", "w_up", "w_down") and len(core) == 3:
        E, a, _ = core
        spec = (MODEL_AXIS if ok(E, MODEL_AXIS) else None,
                fsdp if ok(a, fsdp) else None,
                None)
    return lead + tuple(spec)


def param_shardings(abstract_params, mesh, dp_only: bool = False,
                    tp_only: bool = False, ddp: bool = False):
    """Tree of `NamedSharding` matching abstract_params (any tree of
    tensors, meta or real).

    tp_only (serving): weights replicated across the data axis and sharded
    over `model` only -- no per-step FSDP all-gather on the decode path.

    ddp (tiny models): weights fully replicated; the only collective left is
    the per-step gradient all-reduce.
    """

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if ddp:
            return _sharding(mesh, (None,) * len(tree.shape))
        spec = _spec_for(path, tuple(tree.shape), mesh, dp_only=dp_only)
        if tp_only:
            spec = tuple(None if (ax is not None and ax != MODEL_AXIS
                                  and MODEL_AXIS not in _axes_of(ax))
                         else ax for ax in spec)
        return _sharding(mesh, spec)

    return walk(abstract_params)


def batch_spec(mesh) -> tuple:
    """Activations: batch over (pod, data)."""
    return (_entry(_fsdp(mesh)),)


def batch_shardings(batch_abstract, mesh, dp_only: bool = False):
    fsdp = _fsdp(mesh, dp_only)
    n = _size(_axis_sizes(mesh), fsdp) if fsdp else 1

    def leaf(x: torch.Tensor):
        # shard the leading (batch) dim when divisible
        if x.dim() and x.shape[0] % n == 0 and n > 1:
            return _sharding(mesh, (fsdp,) + (None,) * (x.dim() - 1))
        return _sharding(mesh, (None,) * x.dim())

    return tree_map(leaf, batch_abstract)


def cache_shardings(cache_abstract, mesh):
    """KV/SSM caches: [L, B, ...] -- batch over (pod,data), heads over model."""
    sizes = _axis_sizes(mesh)
    fsdp = _fsdp(mesh)
    n_dp = _size(sizes, fsdp) if fsdp else 1
    n_mp = sizes.get(MODEL_AXIS, 1)

    def leaf(x: torch.Tensor):
        sh = tuple(x.shape)
        spec = [None] * len(sh)
        if len(sh) >= 2 and sh[1] % n_dp == 0 and n_dp > 1:
            spec[1] = fsdp
        # heads axis: KV caches [L,B,S,H,D] -> axis 3; ssm h [L,B,H,N,P] -> axis 2
        for ax in (3, 2):
            if len(sh) > ax + 1 and sh[ax] % n_mp == 0 and n_mp > 1 and spec[ax] is None:
                spec[ax] = MODEL_AXIS
                break
        return _sharding(mesh, spec)

    return tree_map(leaf, cache_abstract)


__all__ = ["param_shardings", "batch_spec", "batch_shardings", "cache_shardings",
           "DATA_AXES", "MODEL_AXIS", "AbstractMesh", "NamedSharding",
           "shard_shape", "placements", "distribute"]
