"""The port on the card: each CUDA kernel against its plain version, and
card runs of the cluster against CPU runs, bit for bit.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). The file imports neither JAX nor `repro`, so it
runs where only the port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import VectorizedConfig, make_cluster
from repro_torch.kernels import dom_admit as admit_mod
from repro_torch.kernels import dom_release as release_mod
from repro_torch.sim.network import NetworkParams
from repro_torch.sim.workload import Workload, WorkloadDriver

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(rng, n, r=3, drop=0.02):
    send = np.sort(rng.uniform(0, n / 2e5, n))
    d = send + 120e-6
    a = send[:, None] + rng.lognormal(np.log(60e-6), 0.6, (n, r))
    a[rng.random((n, r)) < drop] = np.inf
    return d, a


@pytest.mark.parametrize("n,r", [(1, 3), (2047, 3), (2049, 1), (4099, 5),
                                 (65536, 3), (300_001, 3)])
def test_admit_kernel_equals_plain(dev, n, r):
    rng = np.random.default_rng(n)
    d, a = _batch(rng, n, r)
    d[rng.random(n) < 0.01] = np.inf            # dropped stamps
    dt, at = torch.as_tensor(d, device=dev), torch.as_tensor(a, device=dev)
    assert torch.equal(admit_mod.dom_admit_cuda(dt, at),
                       admit_mod.dom_admit_plain(dt, at))


def test_admit_kernel_grid_ties_and_dropped_receiver(dev):
    rng = np.random.default_rng(3)
    n = 5000
    d = rng.integers(0, 4 * 64, n) / 64.0
    a = rng.integers(0, 6 * 64, (n, 3)) / 64.0
    a[rng.random((n, 3)) < 0.15] = np.inf
    a[:, 2] = np.inf                            # a receiver dropping all
    dt, at = torch.as_tensor(d, device=dev), torch.as_tensor(a, device=dev)
    got = admit_mod.dom_admit_cuda(dt, at)
    assert torch.equal(got, admit_mod.dom_admit_plain(dt, at))
    assert not bool(got[:, 2].any())


@pytest.mark.parametrize("n", [1, 2048, 2049, 100_000, 1 << 20])
def test_release_kernel_equals_plain(dev, n):
    rng = np.random.default_rng(n)
    d = rng.integers(0, 1 << 12, n) / 4096.0    # many exact ties
    d[rng.random(n) < 0.05] = np.inf
    dt = torch.as_tensor(d, device=dev)
    for adm, now in ((torch.ones(n, dtype=torch.bool, device=dev),
                      float("inf")),
                     (torch.as_tensor(rng.random(n) < 0.7, device=dev), 0.5)):
        got = release_mod.dom_release_cuda(dt, adm, now)
        want = release_mod.dom_release_plain(dt, adm, now)
        assert torch.equal(got[0], want[0])
        assert int(got[1]) == int(want[1])


def test_wrappers_launch_the_kernels_on_cuda_tensors(dev):
    rng = np.random.default_rng(0)
    d, a = _batch(rng, 100)
    before = (admit_mod.launches, release_mod.launches)
    dt, at = torch.as_tensor(d, device=dev), torch.as_tensor(a, device=dev)
    admit_mod.dom_admit(dt, at)
    release_mod.dom_release(dt, torch.ones(100, dtype=torch.bool,
                                           device=dev), float("inf"))
    assert (admit_mod.launches, release_mod.launches) == \
        (before[0] + 1, before[1] + 1)


def _run(device, crash=None, **cfg_kw):
    cfg = VectorizedConfig(f=1, n_clients=4, seed=3, device=device, **cfg_kw)
    cl = make_cluster("nezha-vectorized", cfg)
    w = Workload(rate_per_client=50_000.0, duration=0.12, seed=5)
    WorkloadDriver(w).inject_open_loop(cl)
    if crash is not None:
        cl.crash_at(crash, 0)
    cl.run_for(w.duration + w.drain)
    return cl


@pytest.mark.parametrize("crash,cfg_kw", [
    (None, {"epochs_per_dispatch": 16, "client_timeout": 1.0}),
    (0.053, {"epochs_per_dispatch": 16,
             "net": NetworkParams(drop_prob=0.05)}),
    (None, {"deadline_cap": 60e-6, "commutative": False}),
])
def test_card_run_equals_cpu_run_bitwise(dev, crash, cfg_kw):
    gpu = _run("cuda", crash, **cfg_kw)
    cpu = _run("cpu", crash, **cfg_kw)
    a, b = gpu.summary(), cpu.summary()
    assert a["tier"] == "torch-cuda" and b["tier"] == "torch-cpu"
    for key in a:
        if key not in ("tier", "backend"):
            assert a[key] == b[key] or (np.isnan(a[key]) and np.isnan(b[key]))
    assert np.concatenate(gpu._latencies).tobytes() == \
        np.concatenate(cpu._latencies).tobytes()
    for x, y in zip(gpu._trace_commits, cpu._trace_commits):
        for cx, cy in zip(x, y):
            assert np.asarray(cx).tobytes() == np.asarray(cy).tobytes()
    lg, lc = gpu.engine.logs.log_columns(), cpu.engine.logs.log_columns()
    for col in lg:
        assert lg[col].tobytes() == lc[col].tobytes(), col
