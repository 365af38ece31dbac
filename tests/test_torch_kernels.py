"""The port's DOM kernels (repro_torch.kernels) against the reference's
Pallas kernels (interpret mode, float64) and numpy oracles.

Tolerance: exact -- admission is boolean, the release order and count are
integers. Inputs are made with numpy from a seed. The CUDA kernels run only
on the card (marker ``cuda``); here the wrappers take the plain versions
because the tensors lie on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vectorized import dom_admit_watermark_np
from repro.kernels.dom_admit import dom_admit_pallas
from repro.kernels.dom_release import dom_release_pallas
from repro_torch.kernels import dom_admit as admit_mod
from repro_torch.kernels import dom_release as release_mod
from repro_torch.kernels import ops
from repro_torch.kernels.timekeys import KEY_INF, KEY_TOP, time_sort_keys

RNG = np.random.default_rng(7)


def _pallas_admit(d, a):
    with jax.enable_x64(True):
        got = dom_admit_pallas(jnp.asarray(d, jnp.float64),
                               jnp.asarray(a.T, jnp.float64), interpret=True)
        return np.asarray(got).T


def _pallas_release(d, admitted, now):
    with jax.enable_x64(True):
        order, count = dom_release_pallas(
            jnp.asarray(d, jnp.float64), jnp.asarray(admitted),
            jnp.asarray(now, jnp.float64), interpret=True)
        return np.asarray(order), int(count)


def _port_admit(d, a):
    return admit_mod.dom_admit(torch.as_tensor(d, dtype=torch.float64),
                               torch.as_tensor(a, dtype=torch.float64)).numpy()


def _port_release(d, admitted, now):
    order, count = release_mod.dom_release(
        torch.as_tensor(d, dtype=torch.float64), torch.as_tensor(admitted),
        now)
    return order.numpy(), int(count)


def _check_admit(d, a):
    got = _port_admit(d, a)
    np.testing.assert_array_equal(got, dom_admit_watermark_np(d, a))
    np.testing.assert_array_equal(got, _pallas_admit(d, a))
    return got


def _stable_release_oracle(d, admitted, now):
    released = admitted & (d <= now)
    keys = np.where(released, d, np.inf)
    order = np.argsort(keys, kind="stable")
    k = int(released.sum())
    return order[:k], k


# ---------------------------------------------------------------------------
# dom_admit
# ---------------------------------------------------------------------------
@pytest.mark.pallas
@pytest.mark.parametrize("n,R", [(8, 1), (33, 3), (64, 2), (100, 3), (256, 5)])
def test_admit_grid_duplicates_match_pallas_and_numpy(n, R):
    """Grid-valued deadlines and arrivals (k/64): duplicates and arrival
    ties everywhere, n not always a power of two."""
    d = RNG.integers(0, 4 * 64, n) / 64.0
    a = RNG.integers(0, 6 * 64, (n, R)) / 64.0
    a[RNG.random((n, R)) < 0.15] = np.inf
    _check_admit(d, a)


@pytest.mark.pallas
def test_admit_realistic_owd_matches_pallas_and_numpy():
    n = 256
    send = np.sort(RNG.uniform(0, 5e-3, n)) + np.arange(n) * 1e-6
    d = send + 120e-6
    a = send[:, None] + RNG.lognormal(np.log(60e-6), 0.6, (n, 3))
    a[RNG.random((n, 3)) < 0.02] = np.inf
    got = _check_admit(d, a)
    assert got.any() and not got.all()


@pytest.mark.pallas
def test_admit_sub_f32_ties_match_pallas_and_numpy():
    """Separations far below float32 resolution: the 64-bit keys keep the
    exact float64 order."""
    base = np.sort(RNG.uniform(1.0, 5.0, 64))
    d = np.repeat(base, 4) + np.tile([0.0, 1e-9, 2e-9, 3e-9], 64)
    d = d[RNG.permutation(d.size)]
    a = (d + RNG.uniform(-2e-9, 2e-9, d.size))[:, None] \
        + np.array([0.0, 1e-9, 5e-9])
    a[RNG.random(a.shape) < 0.1] = np.inf
    assert np.float32(base[0]) == np.float32(base[0] + 1e-9)
    _check_admit(d, a)


@pytest.mark.pallas
def test_admit_all_dropped_receiver_and_inf_deadlines():
    d = np.arange(12) / 8.0
    d[[3, 7]] = np.inf
    a = np.full((12, 2), np.inf)
    a[:, 1] = (np.arange(12) + 2) / 8.0
    got = _check_admit(d, a)
    assert not got[:, 0].any()
    assert got[3, 1] and got[7, 1]          # +inf deadline: admitted


def test_admit_empty_batch():
    got = _port_admit(np.zeros(0), np.zeros((0, 3)))
    assert got.shape == (0, 3)


# ---------------------------------------------------------------------------
# dom_release
# ---------------------------------------------------------------------------
@pytest.mark.pallas
@pytest.mark.parametrize("n", [8, 64, 100, 256])
def test_release_matches_pallas_and_stable_argsort(n):
    d = RNG.uniform(0, 1, n)
    admitted = RNG.random(n) < 0.8
    now = 0.6
    order, count = _port_release(d, admitted, now)
    want, k = _stable_release_oracle(d, admitted, now)
    assert count == k
    np.testing.assert_array_equal(order[:k], want)
    assert (order[k:] == -1).all()
    p_order, p_count = _pallas_release(d, admitted, now)
    assert p_count == count
    np.testing.assert_array_equal(order, p_order)


@pytest.mark.pallas
def test_release_f64_duplicates_and_1ns_gaps_around_now():
    base = np.sort(RNG.uniform(1.0, 2.0, 32))
    d = np.repeat(base, 4) + np.tile([0.0, 0.0, 1e-9, 2e-9], 32)
    d = d[RNG.permutation(d.size)]
    now = float(base[16] + 1e-9)            # cuts inside a 1 ns cluster
    admitted = RNG.random(d.size) < 0.9
    order, count = _port_release(d, admitted, now)
    want, k = _stable_release_oracle(d, admitted, now)
    assert count == k
    np.testing.assert_array_equal(order[:k], want)
    np.testing.assert_array_equal(order, _pallas_release(d, admitted, now)[0])


@pytest.mark.pallas
def test_deadline_order_with_nonfinite_matches_pallas_and_argsort():
    """The engine's use: every message admitted, clock at +inf -- the
    stable deadline sort, non-finite deadlines last (the order is always a
    permutation)."""
    d = RNG.integers(0, 16, 100) / 8.0
    d[RNG.random(100) < 0.1] = np.inf
    got = ops.dom_deadline_order(d, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.argsort(d, kind="stable"))
    p_order, p_count = _pallas_release(d, np.ones(100, bool), np.inf)
    assert p_count == 100
    np.testing.assert_array_equal(got, p_order)
    assert ops.dom_deadline_order(np.zeros(0), device="cpu").size == 0


# ---------------------------------------------------------------------------
# 64-bit time keys
# ---------------------------------------------------------------------------
def test_time_keys_order_equals_float64_order():
    finite = np.array([0.0, -0.0, 5e-324, -5e-324, 2.2250738585072014e-308,
                       -2.2250738585072014e-308, 1e-9, -1e-9, 1.0,
                       1.0 + 2.0 ** -52, -1.0, 1.7976931348623157e308,
                       -1.7976931348623157e308, 3.5, 3.5])
    x = np.concatenate([finite, RNG.normal(0, 1e-3, 64)])
    k = time_sort_keys(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(k[:, None] < k[None, :],
                                  x[:, None] < x[None, :])
    np.testing.assert_array_equal(k[:, None] == k[None, :],
                                  x[:, None] == x[None, :])
    nonfinite = time_sort_keys(
        torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float64))
    assert (nonfinite.numpy() == KEY_INF).all()
    assert k.max() < KEY_INF < KEY_TOP


def test_time_keys_reject_float32():
    with pytest.raises(TypeError):
        time_sort_keys(torch.zeros(3, dtype=torch.float32))


# ---------------------------------------------------------------------------
# wrappers: device dispatch and launch counts
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (admit_mod.launches, release_mod.launches)
    d = torch.as_tensor(RNG.uniform(0, 1, 32))
    a = torch.as_tensor(RNG.uniform(0, 1, (32, 3)))
    assert torch.equal(admit_mod.dom_admit(d, a),
                       admit_mod.dom_admit_plain(d, a))
    ones = torch.ones(32, dtype=torch.bool)
    got = release_mod.dom_release(d, ones, float("inf"))
    want = release_mod.dom_release_plain(d, ones, float("inf"))
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    assert (admit_mod.launches, release_mod.launches) == before


def test_kernel_launchers_refuse_cpu_tensors_instead_of_falling_back():
    d = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        admit_mod.dom_admit_cuda(d, torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        release_mod.dom_release_cuda(d, torch.ones(4, dtype=torch.bool), 1.0)


def test_wrappers_validate_inputs():
    with pytest.raises(TypeError):
        admit_mod.dom_admit(torch.zeros(4, dtype=torch.float32),
                            torch.zeros((4, 3), dtype=torch.float32))
    with pytest.raises(ValueError):
        admit_mod.dom_admit(torch.zeros(4, dtype=torch.float64),
                            torch.zeros((5, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        release_mod.dom_release(torch.zeros(4, dtype=torch.float64),
                                torch.ones(5, dtype=torch.bool), 1.0)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.dom_admit(np.zeros(4), np.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.dom_deadline_order(np.zeros(4))
