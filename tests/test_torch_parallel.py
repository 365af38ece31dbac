"""The port's collectives, meshes and elastic scaling against the reference.

The collectives run on 4 gloo ranks (and on 1) over a `FileStore` in the
test's temporary directory, each rank a subprocess with its own deadline;
the reference runs the same inputs under `jax.vmap(..., axis_name="r")`,
which gives `psum` and `all_gather` their meaning over the mapped axis.
Sums agree within 1e-6 of the largest value; the local pieces (straggler
feedback, `compress_with_feedback`) are bit for bit. The meshes and
elastic scaling run in this process at world size 1 (gloo)."""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.elastic as jel
import repro.parallel.collectives as jc
from repro.ckpt.replicated_log import ReplicatedMetadataLog as JLog
from repro_torch.ckpt.replicated_log import ReplicatedMetadataLog
from repro_torch.configs import smoke_config
from repro_torch.launch import elastic as tel
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import init_params
from repro_torch.parallel import collectives as tc

ROOT = Path(__file__).resolve().parents[1]
SPAWN_DEADLINE_S = 120.0
SUM_TOL = 1e-6
MASKS = np.array([[1, 0, 1, 1], [0, 0, 0, 0]], np.int32)

WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.parallel import collectives as c

rank, world, store, src, dst = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
data = np.load(src)
out = {}
grads = {"a": torch.from_numpy(data["a"][rank]),
         "b": (torch.from_numpy(data["b"][rank]),)}
for i, masks in enumerate(data["masks"]):
    mean = c.deadline_masked_mean(grads, torch.tensor(masks[rank]))
    out[f"mean_a_{i}"] = mean["a"].numpy()
    out[f"mean_b_{i}"] = mean["b"][0].numpy()
out["car"] = c.compressed_allreduce(torch.from_numpy(data["x"][rank])).numpy()
np.savez(dst, **out)
dist.destroy_process_group()
'''


def _inputs(world: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((world, 8, 5)).astype(np.float32),
            "b": (rng.standard_normal((world, 13)) * 1e3).astype(np.float32),
            "x": (rng.standard_normal((world, 37)) * 0.01).astype(np.float32),
            "masks": MASKS[:, :world]}


def _spawn(tmp_path: Path, world: int, data: dict) -> list:
    """Run the worker on ``world`` gloo ranks; every rank must exit 0 before
    the deadline, else all are killed and the test fails."""
    src, script = tmp_path / "in.npz", tmp_path / "worker.py"
    np.savez(src, **data)
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / "store"), str(src), str(tmp_path / f"rank{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    end = time.monotonic() + SPAWN_DEADLINE_S
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(end - time.monotonic(), 0.1))
            assert p.returncode == 0, out.decode()[-3000:]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {world} ranks did not finish in {SPAWN_DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _close(got, want):
    want = np.asarray(want, np.float32)
    tol = SUM_TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("world", [4, 1])
def test_collectives_on_gloo_ranks_match_the_reference_under_vmap(
        tmp_path, world):
    data = _inputs(world, seed=world)
    got = _spawn(tmp_path, world, data)
    grads = {"a": jnp.asarray(data["a"]), "b": (jnp.asarray(data["b"]),)}
    for i, masks in enumerate(data["masks"]):
        want = jax.vmap(lambda g, m: jc.deadline_masked_mean(g, m, "r"),
                        axis_name="r")(grads, jnp.asarray(masks))
        for r in range(world):
            _close(got[r][f"mean_a_{i}"], want["a"][r])
            _close(got[r][f"mean_b_{i}"], want["b"][0][r])
    want = jax.vmap(lambda x: jc.compressed_allreduce(x, "r"),
                    axis_name="r")(jnp.asarray(data["x"]))
    for r in range(world):
        _close(got[r]["car"], want[r])
        # every rank holds the same sum
        assert got[r]["car"].tobytes() == got[0]["car"].tobytes()


def _bits(x) -> bytes:
    return np.asarray(x, np.float32).tobytes()


@pytest.mark.parametrize("on_time", [True, False])
def test_straggler_feedback_is_the_references_bit_for_bit(on_time):
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "b": (rng.standard_normal(3).astype(np.float32),)}
    r = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "b": (rng.standard_normal(3).astype(np.float32),)}
    tg = {"w": torch.from_numpy(g["w"]), "b": (torch.from_numpy(g["b"][0]),)}
    tr = {"w": torch.from_numpy(r["w"]), "b": (torch.from_numpy(r["b"][0]),)}
    jst = jc.StragglerState(residual=jax.tree.map(jnp.asarray, r))
    jc_out, jnew = jc.apply_straggler_feedback(
        jax.tree.map(jnp.asarray, g), jst, jnp.asarray(on_time))
    tc_out, tnew = tc.apply_straggler_feedback(
        tg, tc.StragglerState(residual=tr), torch.tensor(on_time))
    for a, b in ((jc_out["w"], tc_out["w"]), (jc_out["b"][0], tc_out["b"][0]),
                 (jnew.residual["w"], tnew.residual["w"]),
                 (jnew.residual["b"][0], tnew.residual["b"][0])):
        assert _bits(a) == _bits(b.numpy())
    init = tc.straggler_init(tg)
    assert all(not x.any() and x.dtype == torch.float32
               for x in (init.residual["w"], init.residual["b"][0]))


def test_compress_with_feedback_is_the_references_bit_for_bit():
    rng = np.random.default_rng(4)
    g = {"w": (rng.standard_normal((64, 9)) * 1e-3).astype(np.float32),
         "v": rng.standard_normal(17).astype(np.float32)}
    jstate = jc.compression_init(jax.tree.map(jnp.asarray, g))
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    tstate = tc.compression_init(tg)
    for _ in range(3):                   # the residual carries across steps
        jout, jstate = jc.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), jstate)
        tout, tstate = tc.compress_with_feedback(tg, tstate)
        for k in g:
            assert _bits(jout[k]) == _bits(tout[k].numpy())
            assert _bits(jstate.residual[k]) == _bits(
                tstate.residual[k].numpy())


@pytest.mark.parametrize("mp", [1, 2, 4, 8, 16])
def test_plan_mesh_is_the_references(mp):
    for n in range(1, 601):
        assert tel.plan_mesh(n, model_parallel=mp) == \
            jel.plan_mesh(n, model_parallel=mp)


def test_production_meshes_are_abstract():
    one, two = (tmesh.make_production_mesh(multi_pod=m) for m in (False, True))
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.size == 512


@pytest.fixture(scope="module")
def host_mesh():
    """A one-rank gloo group (started by `make_host_mesh`), ended after."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = tmesh.make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_host_mesh_is_one_rank(host_mesh):
    assert tuple(host_mesh.mesh.shape) == (1, 1)
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert host_mesh.device_type == "cpu"


def test_device_mesh_placement_round_trips_bit_for_bit(host_mesh):
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.parallel.sharding import distribute, param_shardings

    params = init_params(smoke_config("tinyllama-1.1b"), 0, device="cpu")
    sh = param_shardings(params, host_mesh)
    placed = distribute(params, sh)
    wq = placed["layers"]["attn"]["wq"]
    assert isinstance(wq, DTensor)
    # wq [L, d, Hq hd]: d over data, the heads over model
    assert list(wq.placements) == [Shard(1), Shard(2)]
    _each_leaf_equal(placed, params)


def _each_leaf_equal(placed, params):
    if isinstance(params, dict):
        for k in params:
            _each_leaf_equal(placed[k], params[k])
        return
    assert placed.to_local().dtype == params.dtype
    assert torch.equal(placed.to_local().view(torch.uint8),
                       params.view(torch.uint8))
    assert torch.equal(placed.full_tensor(), params)


def test_elastic_step_is_the_references_and_reshards_bit_for_bit(host_mesh):
    world = tel.WorldState(n_devices=2, mesh_shape=(2, 1))
    log, jlog = ReplicatedMetadataLog(), JLog()
    new, mesh = tel.elastic_step(world, [0], log=log, device_type="cpu")
    jnew, jmesh = jel.elastic_step(
        jel.WorldState(n_devices=2, mesh_shape=(2, 1)), jax.devices()[:1],
        log=jlog)
    assert dataclasses.asdict(new) == dataclasses.asdict(jnew)
    assert log.current_scaling() == jlog.current_scaling() == {
        "step": 1, "n_healthy": 1, "mesh": [1, 1]}
    assert tuple(mesh.mesh.shape) == tuple(jmesh.devices.shape) == (1, 1)
    assert tel.elastic_step(new, [0], log=log, device_type="cpu") is None
    params = init_params(smoke_config("mamba2-130m"), 1, device="cpu")
    from repro_torch.parallel.sharding import distribute, param_shardings

    old = distribute(params, param_shardings(params, host_mesh))
    _each_leaf_equal(tel.reshard_state(old, mesh), params)
    _each_leaf_equal(tel.reshard_state(params, mesh), params)
