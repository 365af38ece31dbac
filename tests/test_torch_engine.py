"""The port's fused epoch body (repro_torch.core.engine) against the
reference's staged numpy tier, epoch by epoch, and the port's clock-sync
estimator against the reference's numpy estimator.

Tolerance: bit for bit -- every EpochState field the stages fill must be
identical (float64 values compared as exact equality, NaN-free). Both
engines are built from the same configuration and network seed, so their
host-side samplers draw identical variates; the port runs on the CPU,
where its kernel wrappers take the plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.clock import ClockParams as RefClockParams
from repro.core.clocksync import estimate_offsets as ref_estimate_offsets
from repro.core.engine import PENDING_DTYPE as REF_PENDING_DTYPE
from repro.core.engine import DomEngine as RefEngine
from repro.core.engine import _fetch_estimate as ref_fetch_estimate
from repro.core.vectorized_cluster import VectorizedConfig as RefConfig
from repro.sim.network import CloudNetwork as RefNetwork
from repro_torch.core.clocksync import estimate_offsets
from repro_torch.core.engine import (
    PENDING_DTYPE,
    DomEngine,
    _build_epoch_body,
    _fetch_estimate,
    _pull,
)
from repro_torch.core.vectorized_cluster import config_from_reference
from repro_torch.sim.network import CloudNetwork

FIELDS = ("stamp", "deadlines", "arrivals", "admitted", "release",
          "commit_time", "fast", "committed", "exec_order", "bound",
          "latency", "delivered", "reply_owd", "commit_at_client")


def _engines(**cfg_kw):
    rc = RefConfig(f=1, n_clients=8, seed=4, **cfg_kw)
    cfg = config_from_reference(dataclasses.asdict(rc), device="cpu")
    n = 3
    total = n + rc.n_proxies + rc.n_clients
    ref = RefEngine(rc, RefNetwork(total, rc.net, seed=rc.seed), n,
                    tier="numpy")
    port = DomEngine(cfg, CloudNetwork(total, cfg.net, seed=cfg.seed), n)
    return ref, port


def _due(rng, n, t0, span=10e-3, n_clients=8, prestamp=False):
    due = np.zeros(n, REF_PENDING_DTYPE)
    due["t"] = np.sort(rng.uniform(t0, t0 + span, n))
    due["t0"] = due["t"]
    due["cid"] = rng.integers(0, n_clients, n)
    due["rid"] = np.arange(n) + int(t0 * 1e6)
    due["kcls"] = rng.integers(-1, 40, n)
    if prestamp:
        pick = rng.random(n) < 0.1
        due["dl"][pick] = due["t"][pick] + 150e-6
    assert PENDING_DTYPE == REF_PENDING_DTYPE
    return due


def _assert_states_equal(a, b, epoch):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        x = np.asarray(x)
        y = np.asarray(y)
        assert x.shape == y.shape, f"epoch {epoch}: {name} shape"
        assert x.tobytes() == y.tobytes(), f"epoch {epoch}: {name} differs"


def _apply(eng, fault):
    if fault == "clock":
        eng.set_clock_fault("replica", 1, 20e-6, 10e-6)
        eng.set_clock_fault("proxy", 0, -15e-6, 5e-6)
    elif fault == "partition":
        eng.set_partition([2])
    elif fault == "gray":
        eng.set_gray([0], [1], 80e-6, 30e-6, 0.2)
    elif fault == "stamp-bias":
        eng.set_stamp_bias(0, 40e-6)


@pytest.mark.parametrize("fault,cfg_kw", [
    ("none", {}),
    ("none", {"commutative": False}),
    ("cap", {"deadline_cap": 60e-6}),
    ("crash", {}),
    ("clock", {}),
    ("partition", {}),
    ("gray", {}),
    ("stamp-bias", {}),
    ("prestamped", {}),
    ("floor", {}),
])
def test_fused_body_matches_staged_numpy_tier(fault, cfg_kw):
    """Every optional operand of the body: dies_at, clock offsets,
    pair_drop/pair_delay, pre_dl, the release floor and the deadline cap,
    over consecutive epochs (the ring pool carries across them)."""
    ref, port = _engines(**cfg_kw)
    for eng in (ref, port):
        _apply(eng, fault)
    rng = np.random.default_rng(9)
    alive = np.ones(3, bool)
    for epoch in range(4):
        t0 = epoch * 10e-3
        due = _due(rng, 300 + 57 * epoch, t0,
                   prestamp=fault == "prestamped")
        dies_at = None
        if fault == "crash" and epoch == 2:
            dies_at = np.array([t0 + 6e-3, np.inf, np.inf])
        floor = t0 + 3e-3 if fault == "floor" and epoch == 1 else 0.0
        sa = ref.run_epoch(due.copy(), alive, 0, floor, dies_at=dies_at)
        sb = port.run_epoch(due.copy(), alive, 0, floor, dies_at=dies_at)
        _assert_states_equal(sa, sb, epoch)
        if fault == "crash" and epoch == 2:
            alive = np.array([False, True, True])
    np.testing.assert_array_equal(ref.owd_pool, port.owd_pool)
    for col, arr in ref.logs.log_columns().items():
        assert arr.tobytes() == port.logs.log_columns()[col].tobytes(), col


def test_sync_round_runs_in_the_body_and_matches_numpy():
    """A modeled sync round rides the epoch: the torch estimator inside the
    body equals the reference's numpy twin, and the corrections fold at the
    same epoch boundary."""
    clock = dataclasses.asdict(RefClockParams(sync_model=True,
                                              sync_interval=0.01))
    ref, port = _engines(clock=RefClockParams(**clock))
    rng = np.random.default_rng(2)
    alive = np.ones(3, bool)
    for epoch in range(5):
        t0 = epoch * 10e-3
        for eng in (ref, port):
            eng.advance_sync(t0 + 10e-3)
        due = _due(rng, 200, t0)
        sa = ref.run_epoch(due.copy(), alive, 0)
        sb = port.run_epoch(due.copy(), alive, 0)
        _assert_states_equal(sa, sb, epoch)
    assert ref.clocksync.rounds == port.clocksync.rounds > 0
    assert ref.clocksync.correction.tobytes() == \
        port.clocksync.correction.tobytes()
    assert ref.clocksync.sigma.tobytes() == port.clocksync.sigma.tobytes()


@pytest.mark.parametrize("k", [4, 16])
def test_window_equals_single_epochs_and_the_reference(k):
    """K epochs through `run_window` (one pull) == K single epochs of the
    port == the reference's staged numpy tier, bit for bit; empty epochs in
    the window are inert."""
    ref, one = _engines()
    _, win = _engines()
    rng = np.random.default_rng(5)
    dues = [_due(rng, 150 + 31 * i, i * 10e-3) if i % 3 != 1
            else np.zeros(0, PENDING_DTYPE) for i in range(k)]
    alive = np.ones(3, bool)
    states = win.run_window([d.copy() for d in dues], alive, 0)
    for i, due in enumerate(dues):
        if due.size == 0:
            assert states[i] is None
            continue
        sa = ref.run_epoch(due.copy(), alive, 0)
        sb = one.run_epoch(due.copy(), alive, 0)
        _assert_states_equal(sa, sb, i)
        _assert_states_equal(sb, states[i], i)
    np.testing.assert_array_equal(ref.owd_pool, win.owd_pool)


def test_load_pool_state_takes_the_reference_ring():
    """The reference engine's (pool, ptr, cnt) ring, carried over, gives the
    port the same sliding pool -- and so the same DOM bound."""
    ref, port = _engines()
    rng = np.random.default_rng(1)
    alive = np.ones(3, bool)
    for epoch in range(5):          # > window: the ring has wrapped
        ref.run_epoch(_due(rng, 900, epoch * 10e-3), alive, 0)
    pool, ptr, cnt = ref.device_pool_state()
    port.load_pool_state(pool, ptr, cnt)
    np.testing.assert_array_equal(port.owd_pool, ref.owd_pool)
    assert port.device_pool_state()[0].tobytes() == pool.tobytes()
    assert port.update_bound(np.zeros(0)) == ref.update_bound(np.zeros(0))
    # a rotated ring (the device carry's layout) reads back oldest first
    W = pool.size
    rolled = np.roll(pool, 7)
    port.load_pool_state(rolled, (int(ptr) + 7) % W, cnt)
    np.testing.assert_array_equal(port.owd_pool, ref.owd_pool)
    # a partly filled ring, rotated: still the live samples, oldest first
    ref2, port2 = _engines()
    ref2.run_epoch(_due(rng, 100, 0.0), alive, 0)
    pool2, ptr2, cnt2 = ref2.device_pool_state()
    assert cnt2 < W
    port2.load_pool_state(np.roll(pool2, 11), (int(ptr2) + 11) % W, cnt2)
    np.testing.assert_array_equal(port2.owd_pool, ref2.owd_pool)
    with pytest.raises(ValueError):
        port.load_pool_state(pool[:-1], ptr, cnt)


def test_device_fetch_and_bound_equal_the_host_mirrors():
    """The body's tree-mean fetch and ring-pool percentile equal the host
    `_fetch_estimate` (the reference's too) and `update_bound`."""
    rng = np.random.default_rng(3)
    reply = rng.lognormal(np.log(60e-6), 0.6, (37, 3))
    reply[rng.random((37, 3)) < 0.1] = np.inf
    assert _fetch_estimate(reply) == ref_fetch_estimate(reply)
    _, port = _engines()
    body = _build_epoch_body(1, use_kcls=False)
    pool, ptr, cnt = port.device_pool_state()
    n_pad = 64
    owd = np.zeros((n_pad, 3))
    owd[:37] = rng.lognormal(np.log(60e-6), 0.6, (37, 3))
    t = np.full(n_pad, np.inf)
    t[:37] = np.sort(rng.uniform(0, 1e-2, 37))
    def up(x):                  # one group: a leading axis of 1
        return torch.as_tensor(np.asarray(x)[None])

    carry, outs, bound = body(
        up(pool), up(ptr), up(cnt), up(t), up(np.zeros(n_pad)), up(owd),
        up(np.zeros((n_pad, 3), bool)), up(np.full((n_pad, 3), np.inf)),
        up(np.ones(3, bool)), up(np.full(n_pad, -1)), [0], [37],
        **port._scalars(), floor=[0.0])
    want = port.update_bound(owd[:37])
    assert float(bound) == want
    assert int(carry[2]) == 37 * 3 and int(carry[1]) == 37 * 3
    assert outs[8].dtype == torch.int64          # the kernel's deadline order


def test_pull_is_one_buffer_round_trip():
    xs = [torch.arange(5, dtype=torch.float64), torch.tensor([True, False]),
          torch.arange(6, dtype=torch.int64).reshape(2, 3),
          torch.tensor(2.5, dtype=torch.float64)]
    got = _pull(xs)
    for x, y in zip(xs, got):
        assert y.dtype == x.numpy().dtype and y.shape == tuple(x.shape)
        np.testing.assert_array_equal(y, x.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_estimate_offsets_torch_equals_numpy(seed):
    """The sync estimator with xp=torch (as the body runs it) equals the
    reference's numpy estimator exactly, lost probes and outliers
    included."""
    rng = np.random.default_rng(seed)
    m = 4 + seed
    theta = rng.normal(0, 5e-6, (m, m))
    rtt = rng.lognormal(np.log(120e-6), 0.5, (m, m))
    rtt[rng.random((m, m)) < 0.15] = np.inf
    rtt[rng.integers(0, m), rng.integers(0, m)] *= 10.0   # an outlier
    np.fill_diagonal(rtt, np.inf)
    if seed == 3:
        rtt[1, :] = np.inf                               # a deaf node
    want = ref_estimate_offsets(theta, rtt, np, np.float64(1.5),
                                np.float64(200e-9))
    got = estimate_offsets(torch.as_tensor(theta), torch.as_tensor(rtt),
                           torch, 1.5, 200e-9)
    for w, g in zip(want, got):
        assert g.dtype == torch.float64
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    host = estimate_offsets(theta, rtt, np, np.float64(1.5),
                            np.float64(200e-9))
    for w, h in zip(want, host):
        assert np.asarray(h).tobytes() == np.asarray(w).tobytes()
