"""The port's input shapes and sharding rules against the reference's.

`repro_torch.configs.shapes` against `repro.configs.shapes` on all 40
(config x shape) cells: the same kind, tree, shapes and dtypes, the same
skip reason. `repro_torch.parallel.sharding` against
`repro.parallel.sharding` on `jax.sharding.AbstractMesh` (no devices) of
16x16 ("data", "model") and 2x16x16 ("pod", "data", "model"): every
leaf's spec of every config's params (default, `dp_only`, `tp_only`,
`ddp`), of every cell's batch and of every decode cell's cache, and each
leaf's per-device shape against `NamedSharding.shard_shape`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

import repro.configs.shapes as jshapes
import repro.models.model as jm
import repro.parallel.sharding as jsh
from repro.configs import get_config as j_get_config
from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs import shapes as tshapes
from repro_torch.models import model as tm
from repro_torch.parallel import sharding as tsh

ARCHS = all_arch_names()
SHAPES = list(tshapes.SHAPES)
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = {"default": {}, "dp_only": {"dp_only": True},
            "tp_only": {"tp_only": True}, "ddp": {"ddp": True}}


def _meshes(name):
    sizes, names = MESHES[name]
    return JAbstractMesh(sizes, names), tsh.AbstractMesh(sizes, names)


def _pairs(j, t, path=()):
    """(path, reference leaf, port leaf) over two trees of one structure."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), path
        for k in sorted(j):
            yield from _pairs(j[k], t[k], path + (k,))
    elif isinstance(j, (tuple, list)):
        assert isinstance(t, (tuple, list)) and len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            yield from _pairs(a, b, path + (i,))
    else:
        yield path, j, t


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(jnp.dtype(x.dtype))


def test_shapes_table_is_the_references():
    assert set(tshapes.SHAPES) == set(jshapes.SHAPES)
    for name, sp in tshapes.SHAPES.items():
        j = jshapes.SHAPES[name]
        assert (sp.name, sp.seq_len, sp.global_batch, sp.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_applicability_are_the_references(arch, shape):
    cfg_j, cfg_t = j_get_config(arch), get_config(arch)
    assert tshapes.shape_applicable(cfg_t, shape) == \
        jshapes.shape_applicable(cfg_j, shape)
    kind_j, specs_j = jshapes.input_specs(cfg_j, shape)
    kind_t, specs_t = tshapes.input_specs(cfg_t, shape)
    assert kind_t == kind_j
    n = 0
    for path, j, t in _pairs(specs_j, specs_t):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(j.shape), path
        assert _dtype(t) == _dtype(j), path
        n += 1
    assert n >= 1


def test_the_skipped_cells_are_the_references_eight():
    skipped = [(a, s) for a, s in CELLS
               if not tshapes.shape_applicable(get_config(a), s)[0]]
    assert len(skipped) == 8 and {s for _, s in skipped} == {"long_500k"}


def _check_specs(j_shardings, leaves, t_shardings, tmesh) -> int:
    """Every leaf: the same spec and the same per-device shape."""
    n = 0
    for (path, js, ts), (_, leaf, _) in zip(
            _pairs(j_shardings, t_shardings), _pairs(leaves, t_shardings)):
        assert isinstance(js, JNamedSharding), path
        assert isinstance(ts, tsh.NamedSharding) and ts.mesh == tmesh
        assert ts.spec == tuple(js.spec), (path, ts.spec, js.spec)
        assert ts.shard_shape(leaf.shape) == tuple(
            js.shard_shape(tuple(leaf.shape))), path
        n += 1
    return n


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_are_the_references(arch, mesh, variant):
    jmesh, tmesh = _meshes(mesh)
    kw = VARIANTS[variant]
    ap = jm.abstract_params(j_get_config(arch))
    js = jsh.param_shardings(ap, jmesh, **kw)
    ts = tsh.param_shardings(tm.abstract_params(get_config(arch)), tmesh,
                             **kw)
    assert _check_specs(js, ap, ts, tmesh) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_are_the_references(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    assert tsh.batch_spec(tmesh) == tuple(jsh.batch_spec(jmesh))
    cfg_j, cfg_t = j_get_config(arch), get_config(arch)
    for shape in SHAPES:
        kind, specs_j = jshapes.input_specs(cfg_j, shape)
        _, specs_t = tshapes.input_specs(cfg_t, shape)
        for dp_only in (False, True):
            key = "tokens" if kind == "decode" else "batch"
            js = jsh.batch_shardings(specs_j[key], jmesh, dp_only=dp_only)
            ts = tsh.batch_shardings(specs_t[key], tmesh, dp_only=dp_only)
            assert _check_specs(js, specs_j[key], ts, tmesh) > 0
        if kind == "decode":
            js = jsh.cache_shardings(specs_j["cache"], jmesh)
            ts = tsh.cache_shardings(specs_t["cache"], tmesh)
            assert _check_specs(js, specs_j["cache"], ts, tmesh) > 0


@pytest.mark.parametrize("arch", ["qwen2-7b", "dbrx-132b", "mamba2-130m",
                                  "hymba-1.5b", "seamless-m4t-large-v2"])
def test_param_shardings_cover_and_divide(arch):
    """`tests/test_substrate.py::test_param_shardings_cover_and_divide` on
    the port's rules, on a 2x2 (data, model) mesh."""
    mesh = tsh.AbstractMesh((2, 2), ("data", "model"))
    ap = tm.abstract_params(get_config(arch))
    sh = tsh.param_shardings(ap, mesh)
    for path, p, s in _pairs(ap, sh):
        spec = s.spec
        assert len(spec) <= len(p.shape)
        for dim, ax in zip(p.shape, spec):
            if ax is None:
                continue
            n = int(np.prod([mesh.shape[a] for a in
                             (ax if isinstance(ax, tuple) else (ax,))]))
            assert dim % n == 0, f"{arch}: {p.shape} not divisible by {spec}"


def test_shard_shape_divides_and_refuses_a_remainder():
    mesh = tsh.AbstractMesh((2, 4, 8), ("pod", "data", "model"))
    assert tsh.shard_shape((16, 32, 5), (("pod", "data"), "model", None),
                           mesh) == (2, 4, 5)
    assert tsh.shard_shape((3,), (None,), mesh) == (3,)
    with pytest.raises(ValueError, match="does not divide"):
        tsh.shard_shape((12,), ("model",), mesh)
    assert mesh.size == 64 and mesh.shape == {"pod": 2, "data": 4, "model": 8}


def test_one_name_tuples_are_written_as_the_name():
    """The port's spec entries take `PartitionSpec`'s canonical form."""
    mesh = tsh.AbstractMesh((16, 16), ("data", "model"))
    s = tsh.param_shardings({"layers": {"attn": {"wq": torch.empty(
        (2, 64, 64), device="meta")}}}, mesh)["layers"]["attn"]["wq"]
    assert s.spec == (None, "data", "model")
    assert tuple(jax.sharding.PartitionSpec(None, ("data",), "model")) == \
        s.spec
