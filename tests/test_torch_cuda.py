"""The port on the card: each CUDA kernel against its plain version, card
runs of the cluster against CPU runs, bit for bit, the LM paths through
the flash-attention and SSD-scan kernels against the same paths on their
plain versions, and the inchash kernel against its plain version and the
32-bit numpy mirror, bit for bit, eagerly, across calls that shrink and
grow, on two streams at once and replayed from a CUDA graph with new
inputs, in one stream operation a call; cataloged scenarios of
`repro_torch.sim.scenario` on the card against their CPU runs, bit for bit;
and the DOM kernels' batched form over G groups (one launch for all G)
against its plain version, with `nezha-sharded`'s batched path on the card
against its sequential path and the CPU; and the hybrid, MoE,
encoder-decoder and vision-frontend families' prefill on the card against
the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). The file imports neither JAX nor `repro`, so it
runs where only the port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import ctypes
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.core import ShardedConfig, VectorizedConfig, make_cluster
from repro_torch.core.hashing import entry_hash32_np
from repro_torch.kernels import build
from repro_torch.kernels import dom_admit as admit_mod
from repro_torch.kernels import dom_release as release_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import inchash as inchash_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.sim.network import NetworkParams
from repro_torch.sim.scenario import (
    SCENARIO_RESULT_KEYS,
    build_config,
    get_scenario,
)
from repro_torch.sim.trace import (
    check_adversarial,
    check_trace,
    run_scenario_with_trace,
)
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
                                 (65536, 3), (300_001, 3),
                                 # 2N at and past the onesweep tile (4096)
                                 (2048, 3), (4097, 3), (8192, 2)])
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


def _admit_routes():
    return (admit_mod.launches, admit_mod.launches_small,
            admit_mod.launches_onesweep)


def _admit_inputs(rng, n, r, kind):
    """A realistic batch with 3 % infinite deadlines, the 1/64 tie grid, or
    either with its last receiver dropping everything."""
    if kind.startswith("grid"):
        d = rng.integers(0, 4 * 64, n) / 64.0
        a = rng.integers(0, 6 * 64, (n, r)) / 64.0
        a[rng.random((n, r)) < 0.15] = np.inf
    else:
        d, a = _batch(rng, n, r)
    d[rng.random(n) < 0.03] = np.inf
    if kind.endswith("dropped"):
        a[:, -1] = np.inf
    return d, a


@pytest.mark.parametrize("kind", ["realistic", "grid", "realistic_dropped",
                                  "grid_dropped"])
@pytest.mark.parametrize("r", [1, 3, 5, 7])
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2047, 10000, 16383,
                               16384])
def test_admit_small_route_equals_plain_and_onesweep(dev, n, r, kind):
    """The cluster route at the slice's and the bucket's edges, R up to 7
    (f = 3): equal to the plain version, and to the forced onesweep route
    on the same inputs, bit for bit; one launch of each route counted."""
    rng = np.random.default_rng(n * 8 + r)
    d, a = _admit_inputs(rng, n, r, kind)
    dt, at = torch.as_tensor(d, device=dev), torch.as_tensor(a, device=dev)
    want = admit_mod.dom_admit_plain(dt, at)
    before = _admit_routes()
    got = admit_mod.dom_admit_cuda(dt, at)
    assert admit_mod.admit_route(n) == "small"
    assert _admit_routes() == (before[0] + 1, before[1] + 1, before[2])
    assert torch.equal(got, want)
    assert torch.equal(admit_mod.dom_admit_cuda(dt, at, route="onesweep"),
                       want)
    assert _admit_routes() == (before[0] + 2, before[1] + 1, before[2] + 1)
    if kind.endswith("dropped"):
        assert not bool(got[:, -1].any())


def test_admit_small_route_is_deterministic_and_takes_strided_arrivals(dev):
    """Two calls give the same bits; a transposed view of [R, n] arrivals
    (the reference's layout) gives the bits of its contiguous copy."""
    rng = np.random.default_rng(11)
    d, a = _admit_inputs(rng, 16384, 3, "grid")
    dt = torch.as_tensor(d, device=dev)
    at = torch.as_tensor(np.ascontiguousarray(a.T), device=dev).T
    assert not at.is_contiguous()
    first = admit_mod.dom_admit_cuda(dt, at)
    assert torch.equal(first, admit_mod.dom_admit_cuda(dt, at))
    assert torch.equal(first, admit_mod.dom_admit_plain(dt, at.contiguous()))


def test_admit_routes_by_size_and_refusals(dev):
    """16384 takes the small route and 16385 the onesweep one; the small
    route refuses more than SMALL_MAX messages; an empty batch launches
    nothing."""
    rng = np.random.default_rng(5)
    for n, route in ((16384, "small"), (16385, "onesweep")):
        d, a = _admit_inputs(rng, n, 3, "realistic")
        dt = torch.as_tensor(d, device=dev)
        at = torch.as_tensor(a, device=dev)
        total, small, onesweep = _admit_routes()
        assert torch.equal(admit_mod.dom_admit(dt, at),
                           admit_mod.dom_admit_plain(dt, at))
        assert _admit_routes() == (total + 1, small + (route == "small"),
                                   onesweep + (route == "onesweep"))
    with pytest.raises(ValueError):
        admit_mod.dom_admit_cuda(dt, at, route="small")
    with pytest.raises(ValueError):
        admit_mod.dom_admit_cuda(dt, at, route="bitonic")
    before = _admit_routes()
    empty = admit_mod.dom_admit(torch.zeros(0, dtype=torch.float64,
                                            device=dev),
                                torch.zeros((0, 3), dtype=torch.float64,
                                            device=dev))
    assert empty.shape == (0, 3) and _admit_routes() == before


def test_admit_geometry_and_resident_clusters(dev):
    """The wrapper's SMALL_MAX is the kernel's, and the card holds at least
    one 16-block cluster of the small route at once."""
    fn = build.bind(build.library("dom_admit"), "dom_admit_small_max", [])
    assert fn() == admit_mod.SMALL_MAX
    for r in (1, 3, 7):
        assert admit_mod.small_route_clusters(r) >= 1


def _routes():
    return (release_mod.launches, release_mod.launches_small,
            release_mod.launches_onesweep)


# the small route's edges (one block of 16384 lanes), the onesweep tile's
# (4096) multiples and their neighbours, and 2^24 once
@pytest.mark.parametrize("n", [1, 2048, 2049, 100_000, 1 << 20,
                               2, 1023, 1024, 1025, 16383, 16384, 16385,
                               20479, 20480, 20481, (1 << 20) + 1, 1 << 24])
def test_release_kernel_equals_plain(dev, n):
    rng = np.random.default_rng(n)
    d = rng.integers(0, 1 << 12, n) / 4096.0    # many exact ties
    d[rng.random(n) < 0.05] = np.inf
    dt = torch.as_tensor(d, device=dev)
    total, small, onesweep = _routes()
    for adm, now in ((torch.ones(n, dtype=torch.bool, device=dev),
                      float("inf")),
                     (torch.as_tensor(rng.random(n) < 0.7, device=dev), 0.5)):
        got = release_mod.dom_release_cuda(dt, adm, now)
        want = release_mod.dom_release_plain(dt, adm, now)
        assert torch.equal(got[0], want[0])
        assert int(got[1]) == int(want[1])
    small_route = n <= release_mod.SMALL_MAX
    assert release_mod.release_route(n) == ("small" if small_route
                                            else "onesweep")
    assert _routes() == (total + 2, small + 2 * small_route,
                         onesweep + 2 * (not small_route))


@pytest.mark.parametrize("n", [1, 2, 1023, 4095, 4096, 4097, 16384])
def test_release_onesweep_route_below_the_small_limit(dev, n):
    """Forced onesweep on the small route's sizes: one partial tile, a
    full one, tiles plus one lane; it agrees with the small route."""
    rng = np.random.default_rng(n + 7)
    d = rng.integers(0, 64, n) / 16.0 - 1.0
    d[rng.random(n) < 0.05] = np.inf
    dt = torch.as_tensor(d, device=dev)
    adm = torch.as_tensor(rng.random(n) < 0.8, device=dev)
    want = release_mod.dom_release_plain(dt, adm, 2.0)
    total, small, onesweep = _routes()
    for route in ("onesweep", "small"):
        got = release_mod.dom_release_cuda(dt, adm, 2.0, route=route)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    assert _routes() == (total + 2, small + 1, onesweep + 1)


def _edge_deadlines(kind, n, rng):
    if kind == "ties":
        return np.full(n, 0.125)
    if kind == "all_inf":
        return np.full(n, np.inf)
    if kind == "signed_zeros":
        return rng.choice([0.0, -0.0, 1e-300, -1e-300], n)
    if kind == "subnormals":
        return rng.choice([5e-324, 1e-310, -5e-324, 2.2e-308, 0.0], n)
    if kind == "negative":
        return -rng.uniform(0, 1e6, n)
    if kind == "nonfinite":
        return rng.choice([np.inf, -np.inf, np.nan, 1.0, -1.0], n)
    if kind == "constant_high_bytes":            # 6 of 8 digits constant
        return 1.0 + rng.integers(0, 1 << 16, n) * 2.0 ** -52
    return rng.uniform(0, 1, n)                  # "all_masked"


@pytest.mark.parametrize("n", [777, 16384, 40000])
@pytest.mark.parametrize("kind", ["ties", "all_masked", "all_inf",
                                  "signed_zeros", "subnormals", "negative",
                                  "nonfinite", "constant_high_bytes"])
def test_release_kernel_edge_inputs(dev, kind, n):
    rng = np.random.default_rng(len(kind) * n)
    dt = torch.as_tensor(_edge_deadlines(kind, n, rng), device=dev)
    if kind == "all_masked":
        adm = torch.zeros(n, dtype=torch.bool, device=dev)
    elif kind in ("ties", "constant_high_bytes"):     # passes to skip
        adm = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        adm = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    for now in (float("inf"), 0.5, -0.0):
        got = release_mod.dom_release_cuda(dt, adm, now)
        want = release_mod.dom_release_plain(dt, adm, now)
        assert torch.equal(got[0], want[0]), now
        assert int(got[1]) == int(want[1]), now
    if kind == "all_masked":
        assert int(got[1]) == 0 and bool((got[0] == -1).all())


def test_release_geometry_matches_the_wrappers_mirror(dev):
    """The wrapper's route limit, tile and scratch size are those of the
    CUDA source."""
    fn = build.bind(build.library("dom_release"), "dom_release_geometry",
                    [ctypes.c_int, ctypes.c_int,
                     ctypes.POINTER(ctypes.c_longlong)])
    out = (ctypes.c_longlong * 3)()
    for n in (0, 1, 4095, 4096, 16385, 1 << 20, 1 << 24):
        for G in (1, 2, 64):
            fn(n, G, out)
            assert list(out) == [release_mod.SMALL_MAX,
                                 release_mod.ONESWEEP_TILE,
                                 release_mod.onesweep_scratch_bytes(n, G)]


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


@pytest.mark.parametrize("n", [1, 300, 100_000])
def test_one_shot_commit_classification_on_the_card_equals_the_cpu(dev, n):
    """`nezha_commit_times` (one launch of each DOM kernel) and
    `classify_commits` without ``order`` (one `dom_release` launch) and
    with a capped mask: the card's numpy results are the CPU's, bit for
    bit."""
    from repro_torch.core.engine import classify_commits
    from repro_torch.core.vectorized import nezha_commit_times

    rng = np.random.default_rng(n)
    d, a = _batch(rng, n)
    a[:, 2] = np.inf                                  # a dead replica
    reply = rng.lognormal(np.log(50e-6), 0.5, (n, 3))
    keys = rng.integers(0, 64, n)
    slow = rng.random(n) < 0.2
    for call, want in (
            (lambda device: nezha_commit_times(d, a, reply, 0, 1,
                                               key_ids=keys, device=device),
             (1, 1)),
            (lambda device: classify_commits(
                d, a, np.isfinite(a), np.maximum(d[:, None], a), reply, 0,
                1, key_ids=keys, force_slow=slow, device=device), (0, 1))):
        before = (admit_mod.launches, release_mod.launches)
        card = call("cuda")
        assert (admit_mod.launches - before[0],
                release_mod.launches - before[1]) == want
        cpu = call("cpu")
        assert list(card) == list(cpu)
        for key in cpu:
            assert card[key].dtype == cpu[key].dtype
            assert card[key].tobytes() == cpu[key].tobytes(), key


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


# ---------------------------------------------------------------------------
# flash attention: kernel vs plain version (tolerances of the reference's
# kernel tests, tests/test_kernels.py: 2e-5 float32, 2e-2 bf16)
# ---------------------------------------------------------------------------
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(dev, B, S, Sk, Hq, Hk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor(             # noqa: E731
        rng.standard_normal(shape, dtype=np.float32), device=dev).to(dtype)
    return mk(B, S, Hq, D), mk(B, Sk, Hk, D), mk(B, Sk, Hk, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Sk,Hq,Hk,D,causal,window,q_offset", [
    (1, 64, 64, 4, 4, 64, True, None, 0),
    (2, 200, 200, 8, 2, 64, True, None, 0),       # ragged S = Sk
    (2, 200, 200, 8, 2, 64, False, None, 0),
    (1, 300, 300, 8, 1, 64, True, 32, 0),         # window, MQA
    (1, 130, 130, 4, 2, 64, False, 48, 0),        # non-causal window
    (2, 96, 96, 4, 2, 128, True, None, 0),        # D = 128
    (1, 77, 333, 4, 4, 128, False, None, 0),      # S != Sk
    (1, 1, 257, 8, 2, 64, True, None, 256),       # one query at the end
    (1, 40, 200, 4, 2, 64, True, 16, 160),        # q_offset + window
    (1, 16, 16, 4, 2, 64, True, 4, 40),           # rows that see no key
    # the tensor-core kernel's tile edges (128-row query tiles of two
    # 64-row warpgroups, 128-key KV tiles)
    (1, 63, 63, 4, 2, 64, True, None, 0),
    (1, 64, 64, 8, 2, 128, True, 48, 0),
    (2, 65, 65, 4, 2, 64, True, None, 0),
    (1, 127, 127, 8, 1, 128, True, 100, 0),
    (2, 128, 128, 4, 2, 64, True, None, 0),
    (1, 129, 129, 4, 4, 128, True, 64, 0),
    (1, 4095, 4095, 4, 1, 64, True, None, 0),
    (1, 4095, 4095, 4, 2, 128, True, 1000, 0),
    (2, 129, 65, 4, 2, 128, False, None, 0),      # non-causal, S > Sk
    (1, 63, 4095, 8, 2, 128, False, None, 0),     # non-causal, S < Sk
    # hymba-1.5b's heads (group of 5, window 1024), without and with an
    # offset into a longer context
    (1, 2048, 2048, 25, 5, 64, True, 1024, 0),
    (1, 2048, 4096, 25, 5, 64, True, 1024, 2048),
    # D 96 (phi-3-vision-4.2b: one and a half 64-column atoms): ragged S,
    # non-causal, S != Sk, a window, GQA, and the model's own heads
    (2, 200, 200, 8, 8, 96, True, None, 0),
    (1, 65, 65, 4, 2, 96, True, None, 0),
    (2, 130, 130, 4, 4, 96, False, None, 0),
    (1, 77, 333, 4, 2, 96, False, None, 0),
    (1, 300, 300, 8, 1, 96, True, 64, 0),
    (1, 40, 200, 4, 2, 96, True, 16, 160),
    (1, 1024, 1024, 32, 32, 96, True, None, 0),
    # seamless-m4t-large-v2's cross attention: one decode query over 2048
    # frames, and the encoder's non-causal S = Sk (16 heads of 64)
    (4, 1, 2048, 16, 16, 64, False, None, 0),
    (1, 2048, 2048, 16, 16, 64, False, None, 0),
    # the prefills of phase 12 of chip_smoke.py: seamless-m4t-large-v2's
    # decoder self-attention (16/16 heads), dbrx-132b (48/8, D 128: groups
    # of 6) and arctic-480b (56/8: groups of 7, not a power of two), and
    # groups of 7 at a ragged length
    (2, 4096, 4096, 16, 16, 64, True, None, 0),
    (2, 4096, 4096, 48, 8, 128, True, None, 0),
    (2, 4096, 4096, 56, 8, 128, True, None, 0),
    (1, 200, 200, 14, 2, 128, True, None, 0),
    # D 16 and 32 (the scalar kernel in either type): the reference's
    # kernel-test shapes (tests/test_kernels.py:30-34), then ragged S, an
    # offset and the smoke configs' heads
    (2, 128, 128, 4, 2, 16, True, None, 0),
    (2, 96, 96, 4, 1, 32, True, None, 0),
    (2, 128, 128, 2, 2, 16, False, None, 0),
    (2, 256, 256, 4, 2, 16, True, 64, 0),
    (2, 64, 64, 8, 8, 64, True, None, 0),
    (1, 77, 333, 4, 2, 32, False, None, 0),
    (1, 40, 200, 4, 2, 16, True, 16, 160),
    (1, 128, 128, 4, 2, 32, True, None, 0),
])
def test_flash_attention_kernel_equals_plain(dev, dtype, B, S, Sk, Hq, Hk, D,
                                             causal, window, q_offset):
    q, k, v = _qkv(dev, B, S, Sk, Hq, Hk, D, dtype, seed=S + Sk)
    got = fa_mod.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    want = fa_mod.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max()
    assert float(err.cpu()) <= FA_TOL[dtype]


def test_flash_attention_wrapper_launches_on_cuda_tensors(dev):
    q, k, v = _qkv(dev, 1, 64, 64, 4, 2, 64, torch.bfloat16)
    before = fa_mod.launches
    fa_mod.flash_attention(q, k, v)
    assert fa_mod.launches == before + 1
    with pytest.raises(ValueError):     # the kernel takes D in HEAD_DIMS
        fa_mod.flash_attention(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous())
    with pytest.raises(ValueError):           # no silent copy of a strided q
        fa_mod.flash_attention(q.transpose(1, 2), k, v)
    assert fa_mod.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_more_than_65535_heads(dev, dtype):
    """B x Hq beyond the 65535 a grid's y dimension allows: the (batch,
    head) index lies on grid.x in both kernels."""
    q, k, v = _qkv(dev, 2, 3, 3, 33000, 1100, 64, dtype, seed=5)
    got = fa_mod.flash_attention_cuda(q, k, v)
    want = fa_mod.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max().cpu()) <= \
        FA_TOL[dtype]


def test_flash_attention_routes_by_dtype(dev):
    """bf16 launches the tensor-core kernel, float32 the scalar one (each
    route counts its own launches beside the total); ``scalar=True`` runs
    the scalar kernel on bf16 and agrees with the tensor cores; bf16 at
    D 32 takes the scalar kernel; an unsupported head dim raises before
    any launch."""
    q, k, v = _qkv(dev, 1, 200, 200, 8, 2, 64, torch.bfloat16, seed=7)
    counts = lambda: (fa_mod.launches, fa_mod.launches_tensor_core,  # noqa: E731
                      fa_mod.launches_scalar)
    total, tc, scalar = counts()
    got_tc = fa_mod.flash_attention(q, k, v)
    assert counts() == (total + 1, tc + 1, scalar)
    got_scalar = fa_mod.flash_attention_cuda(q, k, v, scalar=True)
    assert counts() == (total + 2, tc + 1, scalar + 1)
    fa_mod.flash_attention(q.float(), k.float(), v.float())
    assert counts() == (total + 3, tc + 1, scalar + 2)
    torch.cuda.synchronize()
    assert float((got_tc.float() - got_scalar.float()).abs().max().cpu()) \
        <= FA_TOL[torch.bfloat16]
    fa_mod.flash_attention(q[..., :32].contiguous(),
                           k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    assert counts() == (total + 4, tc + 1, scalar + 3)
    with pytest.raises(ValueError):
        fa_mod.flash_attention(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous())
    assert counts() == (total + 4, tc + 1, scalar + 3)


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_raises_when_its_build_or_launch_fails(
        dev, monkeypatch, dtype, D):
    q, k, v = _qkv(dev, 1, 64, 64, 4, 2, D, dtype, seed=9)
    before = fa_mod.launches

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(build, "library", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa_mod.flash_attention(q, k, v)
    monkeypatch.setattr(build, "library", lambda name: _FailingLaunch())
    with pytest.raises(RuntimeError,
                       match="flash_attention kernel launch failed"):
        fa_mod.flash_attention(q, k, v)
    assert fa_mod.launches == before


def test_lm_prefill_through_the_kernel_matches_the_plain_path(dev):
    """A 2-layer model at tinyllama's head shape (Hq 32, Hk 4, D 64): 2
    launches per prefill, and the logits agree with the same prefill on the
    plain attention within bf16 noise (2^-5 of the largest logit)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import init_params, make_prefill

    full = get_config("tinyllama-1.1b")
    cfg = smoke_config("tinyllama-1.1b", n_layers=2, d_model=512,
                       n_heads=full.n_heads, n_kv_heads=full.n_kv_heads,
                       head_dim=64, d_ff=1024, vocab=1024)
    params = init_params(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 300)), device=dev)
    prefill = make_prefill(cfg)
    before = fa_mod.launches
    logits, hidden = prefill(params, {"tokens": tokens})
    assert fa_mod.launches == before + cfg.n_layers
    saved = fa_mod.flash_attention_cuda
    fa_mod.flash_attention_cuda = fa_mod.flash_attention_plain
    try:
        want, _ = prefill(params, {"tokens": tokens})
    finally:
        fa_mod.flash_attention_cuda = saved
    scale = float(want.float().abs().max().cpu())
    err = float((logits.float() - want.float()).abs().max().cpu())
    assert torch.isfinite(hidden).all()
    assert err <= scale * 2 ** -5


# The remaining families at smoke size with head dims the kernel takes
# (64; phi-3-vision 96), and the kernel launches one prefill makes.
FAMILY_SMOKE = {
    "hymba-1.5b": dict(head_dim=64),
    "dbrx-132b": dict(head_dim=64),
    "arctic-480b": dict(head_dim=64),
    "seamless-m4t-large-v2": dict(head_dim=64),
    "phi-3-vision-4.2b": dict(head_dim=96),
}


def _family_batch(cfg, dev, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 150)),
                                       device=dev)}
    if cfg.frontend:
        key = "src" if cfg.enc_dec else "frontend"
        batch[key] = torch.as_tensor(rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32),
            device=dev)
    return batch


class _Routing:
    """Patches `moe.top_k`: records the experts each call picks (the card
    run), then hands the same experts to the next run's calls in order
    (the CPU run), noting each token whose own top-k set differs."""

    def __init__(self, monkeypatch):
        from repro_torch.models import moe

        self.top_k, self.picked, self.replay = moe.top_k, [], None
        self.flips = 0
        monkeypatch.setattr(moe, "top_k", self)

    def __call__(self, probs, k):
        vals, idx = self.top_k(probs, k)
        if self.replay is None:
            self.picked.append(idx.cpu())
            return vals, idx
        forced = self.replay.pop(0).to(probs.device)
        own = torch.sort(idx, -1).values != torch.sort(forced, -1).values
        differ = own.any(-1)
        self.flips += int(differ.sum())
        # a token may take another expert set only on a near-tie: its own
        # top-k mass and the forced set's agree within 2^-6 (a few bf16
        # units of the router's input)
        mass = probs.gather(-1, forced).sum(-1)
        assert bool((vals.sum(-1) - mass <= 2 ** -6 * vals.sum(-1)).all())
        return probs.gather(-1, forced), forced


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(FAMILY_SMOKE))
def test_family_prefill_on_the_card_equals_the_cpu(dev, monkeypatch, name,
                                                   compute):
    """Each remaining family at smoke size (2 layers, d 64, 150 tokens past
    hymba's smoke window of 64), the same parameters on the card and on
    the CPU: the card's prefill launches flash_attention once per
    attention (hymba also ssd_scan once per layer; seamless 2 encoder + 2
    self + 2 cross) on the route of the compute type, and its last logits
    equal the CPU's (the plain versions) within 1e-4 of the largest logit
    in float32 and 2^-5 in bf16. MoE: the CPU run takes the card run's
    experts. Top-k routing is a step function, so in bf16 a token whose
    k-th and (k+1)-th router probabilities all but tie may pick another
    set on the other device; each such token must be a near-tie (the two
    sets' probability mass within 2^-6), and float32 must have none."""
    import repro_torch.models.layers as layers
    import repro_torch.models.model as model
    from repro_torch.configs import smoke_config

    monkeypatch.setattr(layers, "CDT", compute)
    monkeypatch.setattr(model, "CDT", compute)
    cfg = smoke_config(name, **FAMILY_SMOKE[name])
    params = model.init_params(cfg, seed=0, device="cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    on_card = to_card(params)
    prefill = model.make_prefill(cfg)
    routing = _Routing(monkeypatch) if cfg.family == "moe" else None
    counts = (fa_mod.launches, fa_mod.launches_tensor_core, ssd_mod.launches)
    got, hidden = prefill(on_card, _family_batch(cfg, dev))
    torch.cuda.synchronize()
    attn = cfg.n_layers * (3 if cfg.enc_dec else 1)
    route = 1 if compute == torch.bfloat16 else 0
    assert (fa_mod.launches - counts[0], fa_mod.launches_tensor_core -
            counts[1], ssd_mod.launches - counts[2]) == (
        attn, attn * route, cfg.n_layers if cfg.hybrid else 0)
    if routing is not None:
        assert len(routing.picked) == cfg.n_layers
        routing.replay = list(routing.picked)
    want, _ = prefill(params, _family_batch(cfg, "cpu"))
    if routing is not None:
        assert routing.replay == [] and (
            compute == torch.bfloat16 or routing.flips == 0)
    tol = float(want.float().abs().max()) * (
        2 ** -5 if compute == torch.bfloat16 else 1e-4)
    err = (got.float().cpu() - want.float()).abs().max()
    assert torch.isfinite(hidden).all() and float(err) <= tol


SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


def _ssd_inputs(dev, b, S, H, P, N, dtype, dt_dtype, seed=0, bc_dtype=None):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((b, S, H, P), dtype=np.float32))
    dt = torch.as_tensor(np.abs(rng.standard_normal((b, S, H),
                                                    dtype=np.float32)) * 0.3
                         + 0.01)
    A = torch.as_tensor(-np.abs(rng.standard_normal(H, dtype=np.float32))
                        - 0.1)
    B = torch.as_tensor(rng.standard_normal((b, S, N), dtype=np.float32))
    C = torch.as_tensor(rng.standard_normal((b, S, N), dtype=np.float32))
    bc_dtype = bc_dtype or dtype
    return (x.to(dev, dtype), dt.to(dev, dt_dtype), A.to(dev),
            B.to(dev, bc_dtype), C.to(dev, bc_dtype))


def _ssd_close(x, dt, A, B, C, chunk):
    """The kernel's y and h against the plain version's, within the
    reference's kernel-test tolerance of x's dtype; returns (y, h)."""
    y, h = ssd_mod.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)
    y_want, h_want = ssd_mod.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    b, S, H, P = x.shape
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (b, H, B.shape[-1], P)
    tol = SSD_TOL[x.dtype]
    assert torch.allclose(y.float(), y_want.float(), atol=tol, rtol=tol)
    assert torch.allclose(h, h_want, atol=tol, rtol=tol)
    return y, h


@pytest.mark.parametrize("dtype,dt_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("b,S,H,P,N,chunk", [
    (2, 64, 3, 4, 8, 16),             # tests/test_kernels.py:51-55
    (1, 40, 2, 8, 4, 16),
    (2, 128, 4, 16, 16, 32),
    (2, 333, 24, 64, 128, 128),       # ragged tail at mamba2-130m's heads
    (1, 32, 24, 64, 128, 128),        # S < chunk: one chunk of 32
    (1, 300, 5, 40, 16, 64),          # P not a multiple of 16
    (1, 1, 24, 64, 128, 128),         # S 1: one chunk of one row
    (2, 128, 24, 64, 128, 128),       # S = chunk
    (1, 129, 24, 64, 128, 128),       # S = chunk + 1: a one-row tail
    (2, 1000, 4, 64, 128, 64),        # 16 chunks of 64, a 40-row tail
    (1, 1100, 25, 64, 16, 128),       # hymba-1.5b's heads (H 25, N 16)
    (1, 300, 3, 200, 8, 128),         # P 200: four column slices of 64
    (1, 100, 2, 3, 5, 32),            # N P odd: rows unaligned, scalar pass
    (2, 77, 3, 12, 20, 16),           # x rows not 16-byte aligned
])
def test_ssd_scan_kernel_equals_plain(dev, dtype, dt_dtype, b, S, H, P, N,
                                      chunk):
    x, dt, A, B, C = _ssd_inputs(dev, b, S, H, P, N, dtype, dt_dtype, seed=S)
    _ssd_close(x, dt, A, B, C, chunk)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dt_dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_takes_every_mix_of_input_types(dev, x_dtype, bc_dtype,
                                                 dt_dtype):
    """x, B and C, and dt each float32 or bf16: all eight instantiations
    agree with the plain version."""
    x, dt, A, B, C = _ssd_inputs(dev, 2, 270, 6, 64, 32, x_dtype, dt_dtype,
                                 seed=3, bc_dtype=bc_dtype)
    _ssd_close(x, dt, A, B, C, 128)


def test_ssd_scan_crosses_64_chunk_boundaries(dev):
    """b 1, S 8192 at chunk 128: the state passes through 64 chunks, at
    mamba2-130m's heads, as the model calls it (bf16 x, B, C; float32
    dt)."""
    x, dt, A, B, C = _ssd_inputs(dev, 1, 8192, 24, 64, 128, torch.bfloat16,
                                 torch.float32, seed=11)
    _ssd_close(x, dt, A, B, C, 128)


def test_ssd_scan_gives_the_same_bits_every_call(dev):
    """No sum depends on which block ran first: two calls on the same
    inputs give bit-identical y and h."""
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, B, C = _ssd_inputs(dev, 2, 1500, 24, 64, 128, dtype,
                                     torch.float32, seed=13)
        y1, h1 = ssd_mod.ssd_scan_cuda(x, dt, A, B, C)
        y2, h2 = ssd_mod.ssd_scan_cuda(x, dt, A, B, C)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_ssd_scan_launches_once_per_call_at_the_main_shape(dev):
    """Every call through `ssd_scan` at mamba2-130m's prefill shape (b 2,
    S 4096, H 24, P 64, N 128; bf16 x, B, C and float32 dt, and all
    float32) counts one launch and agrees with the plain version."""
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, B, C = _ssd_inputs(dev, 2, 4096, 24, 64, 128, dtype,
                                     torch.float32, seed=17)
        before = ssd_mod.launches
        y, h = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=128)
        assert ssd_mod.launches == before + 1
        y_want, h_want = ssd_mod.ssd_scan_plain(x, dt, A, B, C, chunk=128)
        tol = SSD_TOL[dtype]
        assert torch.allclose(y.float(), y_want.float(), atol=tol, rtol=tol)
        assert torch.allclose(h, h_want, atol=tol, rtol=tol)


def test_ssd_scan_raises_when_its_build_or_launch_fails(dev, monkeypatch):
    x, dt, A, B, C = _ssd_inputs(dev, 1, 200, 2, 16, 16, torch.bfloat16,
                                 torch.float32)
    before = ssd_mod.launches

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(build, "library", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ssd_mod.ssd_scan_cuda(x, dt, A, B, C)
    monkeypatch.setattr(build, "library", lambda name: _FailingLaunch())
    with pytest.raises(RuntimeError, match="ssd_scan kernel launch failed"):
        ssd_mod.ssd_scan_cuda(x, dt, A, B, C)
    assert ssd_mod.launches == before


def test_ssd_scan_takes_the_mixers_strided_views(dev):
    """x, B and C as `mamba_mixer` hands them over: views into one
    [b, S, d_inner + 2N] tensor, no copies."""
    b, S, H, P, N = 2, 200, 4, 16, 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xbc = torch.randn(b, S, H * P + 2 * N, generator=gen,
                      device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(b, S, H, P)
    B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.rand(b, S, H, generator=gen, device=dev) * 0.3 + 0.01
    A = -torch.rand(H, generator=gen, device=dev) - 0.1
    assert not x.is_contiguous() and not B.is_contiguous()
    y, h = ssd_mod.ssd_scan_cuda(x, dt, A, B, C, chunk=64)
    y_want, h_want = ssd_mod.ssd_scan_plain(x, dt, A, B, C, chunk=64)
    assert torch.allclose(y.float(), y_want.float(), atol=5e-2, rtol=5e-2)
    assert torch.allclose(h, h_want, atol=5e-2, rtol=5e-2)


def test_ssd_scan_wrapper_launches_on_cuda_tensors(dev):
    x, dt, A, B, C = _ssd_inputs(dev, 1, 300, 2, 16, 16, torch.bfloat16,
                                 torch.float32)
    before = ssd_mod.launches
    ssd_mod.ssd_scan(x, dt, A, B, C, chunk=16)
    assert ssd_mod.launches == before + 1
    with pytest.raises(ValueError):           # chunks above 128 (Q 256)
        ssd_mod.ssd_scan(x, dt, A, B, C, chunk=256)
    with pytest.raises(ValueError):           # no silent copy of a strided x
        ssd_mod.ssd_scan(x.transpose(2, 3), dt, A, B, C)
    assert ssd_mod.launches == before + 1


def test_ssm_prefill_through_the_kernel_matches_the_plain_path(dev):
    """A 2-layer model at mamba2-130m's head layout (H 24, P 64, N 128,
    chunk 128): 2 launches per prefill, and the logits agree with the same
    prefill on the plain scan within bf16 noise (2^-5 of the largest
    logit)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import init_params, make_prefill

    cfg = smoke_config("mamba2-130m", n_layers=2, d_model=768, vocab=1024,
                       ssm_state=128, ssm_headdim=64, ssm_chunk=128)
    params = init_params(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 300)), device=dev)
    prefill = make_prefill(cfg)
    before, fa_before = ssd_mod.launches, fa_mod.launches
    logits, hidden = prefill(params, {"tokens": tokens})
    assert ssd_mod.launches == before + cfg.n_layers
    assert fa_mod.launches == fa_before
    saved = ssd_mod.ssd_scan_cuda
    ssd_mod.ssd_scan_cuda = ssd_mod.ssd_scan_plain
    try:
        want, _ = prefill(params, {"tokens": tokens})
    finally:
        ssd_mod.ssd_scan_cuda = saved
    scale = float(want.float().abs().max().cpu())
    err = float((logits.float() - want.float()).abs().max().cpu())
    assert torch.isfinite(hidden).all()
    assert err <= scale * 2 ** -5


# ---------------------------------------------------------------------------
# inchash: kernel vs plain version and the numpy mirror, bit for bit
# ---------------------------------------------------------------------------
def _log(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(1_600_000_000_000_000_000, 1_800_000_000_000_000_000, n)
    c = rng.integers(0, 1000, n)
    r = rng.integers(0, 2 ** 40, n)
    for col in (d, c, r):
        neg = rng.random(n) < 0.05
        col[neg] = -rng.integers(1, 2 ** 62, int(neg.sum()))
    return d, c, r


def _bits(x):
    """A uint32 tensor's patterns as int32 (comparable on every device)."""
    return x.view(torch.int32)


T = inchash_mod.TILE


@pytest.mark.parametrize("n", [1, 255, 256, 257, 333, T - 1, T, T + 1,
                               3 * T + 1, 100_003, 1 << 24])
def test_inchash_kernel_equals_plain(dev, n):
    d, c, r = _log(n, seed=n)
    cols = [torch.as_tensor(x, device=dev) for x in (d, c, r)]
    h, pf = inchash_mod.inchash_cuda(*cols)
    h_want, pf_want = inchash_mod.inchash_plain(*cols)
    torch.cuda.synchronize()
    assert h.dtype == pf.dtype == torch.uint32 and h.shape == (n,)
    assert torch.equal(_bits(h), _bits(h_want))
    assert torch.equal(_bits(pf), _bits(pf_want))
    mirror = entry_hash32_np(*(x.astype(np.uint32) for x in (d, c, r)))
    np.testing.assert_array_equal(h.cpu().numpy(), mirror)
    np.testing.assert_array_equal(pf.cpu().numpy(),
                                  np.bitwise_xor.accumulate(mirror))


def test_inchash_takes_strided_columns_and_empty_logs(dev):
    d, c, r = _log(5000, seed=1)
    table = torch.as_tensor(np.stack([d, c, r], axis=1), device=dev)
    cols = [table[:, i] for i in range(3)]
    assert not cols[0].is_contiguous()
    before = inchash_mod.launches
    h, pf = inchash_mod.inchash(*cols)
    assert inchash_mod.launches == before + 1
    h_want, pf_want = inchash_mod.inchash_plain(*cols)
    assert torch.equal(_bits(h), _bits(h_want))
    assert torch.equal(_bits(pf), _bits(pf_want))
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    h, pf = inchash_mod.inchash(empty, empty, empty)
    assert h.shape == pf.shape == (0,) and h.dtype == torch.uint32
    assert inchash_mod.launches == before + 1
    h, pf = ops.inchash(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.int64))
    assert h.shape == pf.shape == (0,) and h.dtype == np.uint32


def test_inchash_host_entry_runs_on_the_card(dev):
    d, c, r = _log(777, seed=2)
    before = inchash_mod.launches
    got = ops.inchash(d, c, r)
    assert inchash_mod.launches == before + 1
    want = ops.inchash(d, c, r, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def _equal_plain(got, cols):
    want = inchash_mod.inchash_plain(*cols)
    return all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def test_inchash_shrinking_and_growing_calls_equal_plain(dev):
    """Back-to-back calls on one stream, no sync between them: smaller after
    larger, and larger than the work area holds (which grows it)."""
    sizes = [3 * T + 1, 100_003, 1, T, (1 << 20) + 5, 257, 2_000_003, 5,
             (1 << 20) + 5]
    logs = [[torch.as_tensor(x, device=dev) for x in _log(n, seed=40 + i)]
            for i, n in enumerate(sizes)]
    before = inchash_mod.launches
    outs = [inchash_mod.inchash_cuda(*cols) for cols in logs]
    torch.cuda.synchronize()
    assert inchash_mod.launches == before + len(sizes)
    for n, got, cols in zip(sizes, outs, logs):
        assert _equal_plain(got, cols), n


def _capture_stream(dev, fn):
    """A side stream on which ``fn`` has run once (its work area made)."""
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    return stream


@pytest.mark.parametrize("n", [1000, (1 << 20) + 7])
def test_inchash_graph_replay_with_new_inputs_equals_plain(dev, n):
    cols = [torch.as_tensor(x, device=dev) for x in _log(n, seed=50)]
    stream = _capture_stream(dev, lambda: inchash_mod.inchash_cuda(*cols))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = inchash_mod.inchash_cuda(*cols)
    small = [torch.as_tensor(x, device=dev)
             for x in _log(max(n // 3, 1), seed=51)]
    for seed in (52, 53, 54):
        for x, y in zip(cols, _log(n, seed=seed)):
            x.copy_(torch.as_tensor(y))
        graph.replay()
        torch.cuda.synchronize()
        assert _equal_plain(got, cols), seed
        with torch.cuda.stream(stream):       # the graph's area, eagerly
            eager = inchash_mod.inchash_cuda(*small)
        torch.cuda.synchronize()
        assert _equal_plain(eager, small)


def _device_ops(fn, calls=5):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("n", [333, 180_191, 1 << 22])
def test_inchash_call_is_one_stream_operation(dev, n):
    cols = [torch.as_tensor(x, device=dev) for x in _log(n, seed=60)]
    ops_by_name = _device_ops(lambda: inchash_mod.inchash_cuda(*cols))
    assert sum(ops_by_name.values()) == 5, ops_by_name
    assert all("inchash" in k for k in ops_by_name), ops_by_name


def test_inchash_host_entry_is_three_stream_operations(dev):
    """One copy in, the kernel, one copy back."""
    d, c, r = _log(180_191, seed=61)
    ops_by_name = _device_ops(lambda: ops.inchash(d, c, r))
    assert sum(ops_by_name.values()) == 3 * 5, ops_by_name
    kernels = sum(v for k, v in ops_by_name.items() if "inchash" in k)
    assert kernels == 5, ops_by_name


def test_inchash_streams_running_at_once_each_equal_plain(dev):
    """Each stream has its own work area: calls on two streams interleave
    without a sync and each result equals the plain version."""
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    logs = [[torch.as_tensor(x, device=dev) for x in _log(n, seed=70 + n)]
            for n in (1 << 21, 3 * T + 5, (1 << 21) + 3, 999)]
    torch.cuda.synchronize()
    outs = []
    for rep in range(3):
        for i, cols in enumerate(logs):
            with torch.cuda.stream(streams[i % 2]):
                outs.append((inchash_mod.inchash_cuda(*cols), cols))
    torch.cuda.synchronize()
    for got, cols in outs:
        assert _equal_plain(got, cols)


def test_inchash_host_entry_results_alias_no_later_call(dev):
    d, c, r = _log(4099, seed=80)
    h, pf = ops.inchash(d, c, r)
    keep = h.copy(), pf.copy()
    d2, c2, r2 = _log(4099, seed=81)
    h2, pf2 = ops.inchash(d2.astype(np.int32), c2[::-1], r2)
    np.testing.assert_array_equal(h, keep[0])
    np.testing.assert_array_equal(pf, keep[1])
    want = ops.inchash(d2.astype(np.int32), c2[::-1], r2, device="cpu")
    np.testing.assert_array_equal(h2, want[0])
    np.testing.assert_array_equal(pf2, want[1])


class _FailingLaunch:
    """A library whose launch returns a CUDA error code."""

    def __init__(self):
        self.inchash_launch = lambda *args: 1          # cudaErrorInvalidValue
        self.dom_release_small_launch = lambda *args: 1
        self.dom_release_onesweep_launch = lambda *args: 1
        self.dom_admit_small_launch = lambda *args: 1
        self.dom_admit_onesweep_launch = lambda *args: 1
        self.flash_attention_launch = lambda *args: 1
        self.flash_attention_tc_launch = lambda *args: 1
        self.ssd_scan_launch = lambda *args: 1
        self.kernel_error_string = lambda code: b"invalid argument"


def test_inchash_raises_when_its_build_or_launch_fails(dev, monkeypatch):
    cols = [torch.as_tensor(x, device=dev) for x in _log(100, seed=3)]
    before = inchash_mod.launches

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(build, "library", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        inchash_mod.inchash(*cols)
    monkeypatch.setattr(build, "library", lambda name: _FailingLaunch())
    with pytest.raises(RuntimeError, match="inchash kernel launch failed"):
        inchash_mod.inchash(*cols)
    assert inchash_mod.launches == before


@pytest.mark.parametrize("n", [100, 20000])
def test_dom_kernels_raise_when_their_build_or_launch_fails(dev, monkeypatch,
                                                            n):
    """No fallback: a failed build or launch raises on either route of
    either DOM kernel (n 100 and 20000 fall on the two routes), and counts
    no launch."""
    rng = np.random.default_rng(n)
    d, a = _batch(rng, n)
    dt, at = torch.as_tensor(d, device=dev), torch.as_tensor(a, device=dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    before = (_routes(), _admit_routes())

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(build, "library", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        release_mod.dom_release(dt, ones, float("inf"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        admit_mod.dom_admit(dt, at)
    monkeypatch.setattr(build, "library", lambda name: _FailingLaunch())
    with pytest.raises(RuntimeError, match="dom_release kernel launch failed"):
        release_mod.dom_release(dt, ones, float("inf"))
    with pytest.raises(RuntimeError, match="dom_admit kernel launch failed"):
        admit_mod.dom_admit(dt, at)
    assert (_routes(), _admit_routes()) == before


def _scenario_pair(scenario, config=None):
    """One scenario on the card and on the CPU, with the DOM launch counts
    of the card run: (card result, card trace, CPU result, CPU trace,
    counts)."""
    for mod in (admit_mod, release_mod):
        mod.launches = mod.launches_small = mod.launches_onesweep = 0
    card = run_scenario_with_trace("nezha-vectorized", scenario,
                                   device="cuda", config=config)
    counts = tuple({"small": m.launches_small, "onesweep": m.launches_onesweep}
                   for m in (admit_mod, release_mod))
    cpu = run_scenario_with_trace("nezha-vectorized", scenario,
                                  device="cpu", config=config)
    return (*card, *cpu, counts)


def _same(a, b, where=""):
    """Bit-for-bit equality through nested dicts, lists and arrays."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def _assert_card_equals_cpu(res_g, tr_g, res_c, tr_c):
    assert (res_g.tier, res_c.tier) == ("torch-cuda", "torch-cpu")
    for key in SCENARIO_RESULT_KEYS:
        if key != "tier":
            _same(getattr(res_g, key), getattr(res_c, key), key)
    for part in ("log", "commits", "stamps", "sync", "durability",
                 "replica_logs", "net_windows"):
        _same(getattr(tr_g, part), getattr(tr_c, part), part)
    assert _findings(tr_g) == _findings(tr_c)


def _findings(tr):
    return [x.replace(tr.label, "<trace>")
            for x in check_adversarial(tr) + check_trace(tr)]


@pytest.mark.parametrize("name", ["leader-crash", "total-outage",
                                  "split-brain-attempt", "flapping-links",
                                  "skewed-proxy", "clock-leap",
                                  "intra-zone-closed", "wan"])
def test_scenario_on_the_card_equals_the_cpu(dev, name):
    """A cataloged scenario through `run_scenario_with_trace` on the card
    equals its CPU run bit for bit (result, trace, findings), with one
    launch of each DOM kernel per epoch with requests."""
    res_g, tr_g, res_c, tr_c, (admit, release) = _scenario_pair(name)
    _assert_card_equals_cpu(res_g, tr_g, res_c, tr_c)
    assert res_g.committed > 0
    assert admit["small"] > 0 and admit == release


def test_total_outage_at_1e6_takes_the_onesweep_route_on_the_card(dev):
    """`total-outage` at 1e6 req/s (10 clients x 1e5, K 16): the epoch
    after the relaunch holds ~8e4 lanes, past the small routes, so both
    DOM kernels run their onesweep route on the main path; card == CPU."""
    sc = get_scenario("total-outage")
    sc = replace(sc, workload=replace(sc.workload, rate_per_client=1e5))
    cfg = replace(build_config("nezha-vectorized", sc),
                  epochs_per_dispatch=16)
    res_g, tr_g, res_c, tr_c, (admit, release) = _scenario_pair(sc, cfg)
    _assert_card_equals_cpu(res_g, tr_g, res_c, tr_c)
    assert admit["onesweep"] > 0 and admit == release


# ---------------------------------------------------------------------------
# the DOM kernels batched over G groups, and nezha-sharded on the card
# ---------------------------------------------------------------------------
def _group_batch(rng, G, n_pad, r=3):
    """G realistic DOM batches of ragged lengths, +inf padding lanes to
    n_pad (group 0 full, the last one a single message)."""
    d = np.full((G, n_pad), np.inf)
    a = np.full((G, n_pad, r), np.inf)
    for g in range(G):
        n = n_pad if g == 0 else 1 if g == G - 1 else \
            int(rng.integers(1, n_pad + 1))
        d[g, :n], a[g, :n] = _batch(rng, n, r)
    return d, a


# phase 11's shapes (G, N): the small route at 4 x 16384, 16 x 4096 and
# 64 x 1024, the onesweep route at 2 x 65536; and odd sizes
@pytest.mark.parametrize("G,n", [(4, 16384), (16, 4096), (64, 1024),
                                 (2, 65536), (3, 333), (5, 16385), (1, 777)])
def test_batched_dom_kernels_equal_plain(dev, G, n):
    """One launch of each DOM kernel for all G groups == the batched plain
    versions, bit for bit, and == G launches of the G 1 form."""
    rng = np.random.default_rng(G * n)
    d, a = _group_batch(rng, G, n)
    dt, at = torch.as_tensor(d, device=dev), torch.as_tensor(a, device=dev)
    small = n <= admit_mod.SMALL_MAX
    before = (_routes(), _admit_routes())
    adm = admit_mod.dom_admit(dt, at)
    order = ops.dom_deadline_order_device(dt)
    assert (_routes(), _admit_routes()) == (
        tuple(x + y for x, y in zip(before[0], (1, small, not small))),
        tuple(x + y for x, y in zip(before[1], (1, small, not small))))
    assert adm.shape == (G, n, 3) and order.shape == (G, n)
    assert torch.equal(adm, admit_mod.dom_admit_plain(dt, at))
    assert torch.equal(order, ops.dom_deadline_order_device(dt.cpu()).to(dev))
    rel, cnt = release_mod.dom_release(dt, adm[..., 1], float(np.median(d[0])))
    want, wcnt = release_mod.dom_release_plain(dt, adm[..., 1],
                                               float(np.median(d[0])))
    assert torch.equal(rel, want) and torch.equal(cnt, wcnt)
    for g in (0, G // 2, G - 1):
        assert torch.equal(adm[g], admit_mod.dom_admit(dt[g], at[g]))
        assert torch.equal(order[g], ops.dom_deadline_order_device(dt[g]))
    if small:                   # the other route on the same inputs
        assert torch.equal(admit_mod.dom_admit_cuda(dt, at, route="onesweep"),
                           adm)
        ones = torch.ones_like(adm[..., 0])
        assert torch.equal(release_mod.dom_release_cuda(
            dt, ones, float("inf"), route="onesweep")[0].to(torch.int64),
            order)


def test_batched_dom_kernels_raise_when_their_build_or_launch_fails(
        dev, monkeypatch):
    """No fallback on the batched form either: no plain version and no
    per-group launches when the build or the launch fails."""
    rng = np.random.default_rng(11)
    d, a = _group_batch(rng, 4, 1024)
    dt, at = torch.as_tensor(d, device=dev), torch.as_tensor(a, device=dev)
    ones = torch.ones(dt.shape, dtype=torch.bool, device=dev)
    before = (_routes(), _admit_routes())
    monkeypatch.setattr(build, "library", lambda name: _FailingLaunch())
    with pytest.raises(RuntimeError, match="dom_release kernel launch failed"):
        release_mod.dom_release(dt, ones, float("inf"))
    with pytest.raises(RuntimeError, match="dom_admit kernel launch failed"):
        admit_mod.dom_admit(dt, at)
    assert (_routes(), _admit_routes()) == before


def _sharded_run(device, G, vmap):
    cfg = ShardedConfig(groups=G, n_clients=8, seed=G, device=device,
                        vmap_groups=vmap, client_timeout=4e-3,
                        net=NetworkParams(drop_prob=0.02))
    cl = make_cluster("nezha-sharded", cfg)
    gens = [0]
    for grp in cl.groups:
        run_epoch = grp.engine.run_epoch

        def counted(*args, _run=run_epoch, **kw):
            gens[0] += 1
            return _run(*args, **kw)
        grp.engine.run_epoch = counted
    for mod in (admit_mod, release_mod):
        mod.launches = mod.launches_small = mod.launches_onesweep = 0
    WorkloadDriver(Workload(rate_per_client=20_000.0, duration=0.08,
                            seed=G)).run(cl)
    counts = (admit_mod.launches, release_mod.launches)
    return cl, gens[0], counts


@pytest.mark.parametrize("G", [4, 16])
def test_sharded_batched_on_the_card_equals_sequential_and_the_cpu(dev, G):
    """`nezha-sharded` with the batched path on the card == its sequential
    path on the card == the CPU, bit for bit; batched, each kernel launches
    once per lockstep epoch with work plus once per retry generation."""
    bat, gens, (admit, release) = _sharded_run("cuda", G, True)
    seq, seq_gens, seq_counts = _sharded_run("cuda", G, False)
    cpu, _, cpu_counts = _sharded_run("cpu", G, True)
    assert bat.vmap_epochs > 0 and admit == release == bat.vmap_epochs + gens
    assert seq_counts == (seq_gens, seq_gens) and cpu_counts == (0, 0)
    s = bat.summary()
    assert s["tier"] == "torch-cuda" and s["committed"] > 0
    for other in (seq, cpu):
        o = other.summary()
        _same({k: v for k, v in s.items() if k not in ("tier",
                                                        "vmap_epochs")},
              {k: v for k, v in o.items() if k not in ("tier",
                                                        "vmap_epochs")})
        _same(bat._merged_latencies()[0], other._merged_latencies()[0])
        for a, b in zip(bat.groups, other.groups):
            for x, y in zip(a._trace_commits, b._trace_commits):
                _same(list(x), list(y))
            _same(a.engine.logs.log_columns(), b.engine.logs.log_columns())


@pytest.mark.parametrize("name", ["sharded-multi-key", "sharded-group-crash"])
def test_sharded_scenario_on_the_card_equals_the_cpu(dev, name):
    card = run_scenario_with_trace("nezha-sharded", name, device="cuda")
    cpu = run_scenario_with_trace("nezha-sharded", name, device="cpu")
    (res_g, tr_g), (res_c, tr_c) = card, cpu
    assert (res_g.tier, res_c.tier) == ("torch-cuda", "torch-cpu")
    assert res_g.skipped_faults == 0 and res_g.committed > 0
    for key in SCENARIO_RESULT_KEYS:
        if key != "tier":
            _same(getattr(res_g, key), getattr(res_c, key), key)
    for g, (a, b) in enumerate(zip(tr_g.groups, tr_c.groups)):
        for part in ("log", "commits", "stamps", "durability"):
            _same(getattr(a, part), getattr(b, part), f"{g} {part}")
    _same(tr_g.multiops, tr_c.multiops)
    assert _findings(tr_g) == _findings(tr_c)
    if name == "sharded-group-crash":
        assert res_g.raw["per_group_view_changes"] == [0, 1, 0, 0]
    else:
        assert res_g.cross_group_violations == 0


def test_small_route_cluster_sizes_match_the_wrappers_mirror(dev):
    """Each small route takes the fewest 1024-lane blocks that hold n, up to
    16, in both kernels' sources as in `small_route_blocks`."""
    rel = build.bind(build.library("dom_release"), "dom_release_small_blocks",
                     [ctypes.c_int])
    adm = build.bind(build.library("dom_admit"), "dom_admit_small_blocks",
                     [ctypes.c_int])
    for n in (0, 1, 1023, 1024, 1025, 2048, 2049, 4096, 8193, 16384):
        want = release_mod.small_route_blocks(n)
        assert rel(n) == adm(n) == want, n
    assert [release_mod.small_route_blocks(n) for n in (977, 3907, 15625)] \
        == [1, 4, 16]


# ---------------------------------------------------------------------------
# training: the kernels under autograd (the C1 repair) and a train step
# ---------------------------------------------------------------------------
def _grads_both_ways(fn_kernel, fn_plain, inputs, weights):
    """Gradients of sum(w * out) through the kernel's autograd Function
    and through autograd of the plain version, same inputs and weights."""
    def grads(fn):
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
        return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)
    return grads(fn_kernel), grads(fn_plain)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_grads_are_the_plain_versions_on_the_card(dev,
                                                                  dtype):
    """Phase 5's shape (B 2, S 4096, 32/4 heads of 64, causal): the
    Function's forward is the kernel's and its gradients are autograd's of
    the plain version, exactly."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 4096, 32, 64, generator=gen, device=dev).to(dt)
    k = torch.randn(2, 4096, 4, 64, generator=gen, device=dev).to(dt)
    v = torch.randn(2, 4096, 4, 64, generator=gen, device=dev).to(dt)
    w = torch.randn(2, 4096, 32, 64, generator=gen, device=dev)
    before = fa_mod.launches
    (out_k, g_k), (out_p, g_p) = _grads_both_ways(
        fa_mod.flash_attention_autograd, fa_mod.flash_attention_plain,
        (q, k, v), (w,))
    assert fa_mod.launches == before + 1
    tol = {"bfloat16": 2e-2, "float32": 2e-5}[dtype]
    assert float((out_k[0].float() - out_p[0].float()).abs().max()) <= tol
    for a, b in zip(g_k, g_p):
        assert a.dtype == dt and torch.equal(a, b)
    # the wrapper takes the Function when the inputs require grad
    assert fa_mod.flash_attention(q.requires_grad_(), k, v).grad_fn \
        is not None


def test_ssd_scan_grads_are_the_plain_versions_on_the_card(dev):
    """Phase 7's shape (b 2, S 4096, H 24, P 64, N 128, chunk 128; x, B, C
    bf16, dt float32; phase 7's input distribution), both outputs
    weighted: every input's gradient is autograd's of the plain version,
    exactly; the forward within phase 7's tolerance."""
    gen = torch.Generator(device=dev).manual_seed(1)
    b, S, H, P, N = 2, 4096, 24, 64, 128
    x = torch.randn(b, S, H, P, generator=gen, device=dev).bfloat16()
    dt = torch.randn(b, S, H, generator=gen, device=dev).abs() * 0.3 + 0.01
    A = -torch.randn(H, generator=gen, device=dev).abs() - 0.1
    B = torch.randn(b, S, N, generator=gen, device=dev).bfloat16()
    C = torch.randn(b, S, N, generator=gen, device=dev).bfloat16()
    wy = torch.randn(b, S, H, P, generator=gen, device=dev)
    wh = torch.randn(b, H, N, P, generator=gen, device=dev)
    before = ssd_mod.launches
    (outs_k, g_k), (outs_p, g_p) = _grads_both_ways(
        lambda *a: ssd_mod.ssd_scan_autograd(*a, chunk=128),
        lambda *a: ssd_mod.ssd_scan_plain(*a, chunk=128),
        (x, dt, A, B, C), (wy, wh))
    assert ssd_mod.launches == before + 1
    diff = (outs_k[0].float() - outs_p[0].float()).abs()
    assert float((diff - 5e-2 * outs_p[0].float().abs()).max()) <= 5e-2
    for a, c in zip(g_k, g_p):
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_smoke_train_step_on_the_card_matches_the_cpu(dev, arch,
                                                      monkeypatch):
    """One `make_train_step` update (microbatches 2, remat "full") at the
    card tests' smoke sizes (two layers at full width: the kernels' head
    dims) in float32 compute from the same state on the card and on
    the CPU: the kernel launches twice a layer and microbatch (the forward
    and its recompute), and every parameter and moment agrees within 1e-4
    of each leaf's largest |value| -- 1e-3 for mamba2-130m, whose float32
    scan kernel holds 2e-4 against its plain version where the attention's
    holds 2e-5."""
    import repro_torch.models.layers as tl
    import repro_torch.models.model as tm
    from repro_torch.configs import smoke_config
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import make_train_state, make_train_step

    for mod in (tl, tm):
        monkeypatch.setattr(mod, "CDT", torch.float32)
    full = {"tinyllama-1.1b": dict(n_heads=32, n_kv_heads=4, head_dim=64,
                                   d_model=512, d_ff=1024),
            "mamba2-130m": dict(d_model=768, ssm_state=128, ssm_headdim=64,
                                ssm_chunk=128)}[arch]
    cfg = smoke_config(arch, n_layers=2, vocab=1024, **full)
    state = make_train_state(cfg, seed=0, device="cpu")
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(150, dtype=torch.int32)))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 64)))
    step = make_train_step(cfg, microbatches=2)
    new_cpu, m_cpu = step(state, {"tokens": tokens})
    on_card = tree_map(lambda t: t.to(dev), state.params)
    card_state = type(state)(params=on_card, opt=type(state.opt)(
        step=state.opt.step.to(dev), m=tree_map(lambda t: t.to(dev),
                                                state.opt.m),
        v=tree_map(lambda t: t.to(dev), state.opt.v)))
    mod = ssd_mod if cfg.family == "ssm" else fa_mod
    tol = 1e-3 if cfg.family == "ssm" else 1e-4
    mod.launches = 0
    new_card, m_card = step(card_state, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    assert mod.launches == cfg.n_layers * 2 * 2
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(m_card[key]) - float(m_cpu[key])) <= \
            tol * abs(float(m_cpu[key]))
    for got, want in ((new_card.params, new_cpu.params),
                      (new_card.opt.m, new_cpu.opt.m),
                      (new_card.opt.v, new_cpu.opt.v)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.isfinite(a).all()
            err = float((a.cpu() - b).abs().max())
            assert err <= tol * float(b.abs().max()) + 1e-12
