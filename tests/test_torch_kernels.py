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
from repro_torch.kernels import flash_attention as fa_mod
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
# dom_admit's small route: its schedule in plain torch
# ---------------------------------------------------------------------------
U_INF = np.uint64(0xFFF0000000000000)   # key(+inf), `KEY_INF` in common.cuh
U_SIGN = np.uint64(1 << 63)
SLICE = 1024                            # messages a block of the cluster
CLASS1 = admit_mod.SMALL_MAX            # aux = class * CLASS1 + message


def _ukeys(x):
    """The kernels' unsigned 64-bit time keys (signed key ^ INT64_MIN)."""
    signed = time_sort_keys(torch.as_tensor(x, dtype=torch.float64)).numpy()
    return signed.view(np.uint64) ^ U_SIGN


def _ordered(u):
    """int64 tensor whose signed order is the unsigned order of ``u``."""
    return torch.from_numpy((u ^ U_SIGN).view(np.int64))


def _small_route_twin(d, a):
    """The small route of csrc/dom_admit.cu in plain torch, receiver by
    receiver: the N updates (key max(d, a), aux class * CLASS1 + i) placed
    in aux order; keys compressed (finite keys less the least, +inf one
    above the largest); stable 8-bit LSD passes over the digits that vary;
    the prefix max of the candidates (finite deadline keys, else 0); then
    per test the number of updates that precede it -- a binary search over
    the 1024-update slices' first updates, then inside one slice -- with
    the tie rule: at an equal key, every class-0 update and the class-1
    updates of earlier messages. Returns admitted [N, R] and the passes run
    for each receiver."""
    n, R = a.shape
    out = np.zeros((n, R), bool)
    passes = []
    kd = _ukeys(d)
    msg = np.arange(n, dtype=np.int64)
    tests = torch.arange(n)
    thr = CLASS1 + tests
    n_slices = -(-n // SLICE)
    for r in range(R):
        ka = _ukeys(a[:, r])
        u = np.maximum(kd, ka)
        finite = u != U_INF
        if finite.any():
            least = u[finite].min()
            inf_c = u[finite].max() - least + np.uint64(1)
        else:
            least, inf_c = np.uint64(0), np.uint64(0)
        comp = np.where(finite, u - least, inf_c)
        aux = np.where(kd > ka, 0, CLASS1) + msg
        place = np.argsort(aux, kind="stable")
        keys = torch.from_numpy(comp[place].view(np.int64))
        vals = torch.from_numpy(aux[place])
        varying = int(np.bitwise_or.reduce(comp)) if n else 0
        run = 0
        for p in range(8):
            if (varying >> (8 * p)) & 0xFF:
                digit = (keys >> (8 * p)) & 0xFF
                order = torch.sort(digit, stable=True).indices
                keys, vals = keys[order], vals[order]
                run += 1
        passes.append(run)
        cand = kd[(vals % CLASS1).numpy()]
        pmax = torch.cummax(_ordered(np.where(cand == U_INF, np.uint64(0),
                                              cand)), 0).values
        ku = keys.numpy().view(np.uint64)
        dec = _ordered(np.where(ku == inf_c, U_INF, ku + least))
        key_a = _ordered(ka)

        def precedes(at):
            return (dec[at] < key_a) | ((dec[at] == key_a) & (vals[at] < thr))

        k = torch.zeros(n, dtype=torch.int64)
        for step in (16, 8, 4, 2, 1):
            c = k + step
            ok = (c <= n_slices) & precedes(((c - 1) * SLICE).clamp(max=n - 1))
            k = torch.where(ok, c, k)
        base = (k - 1).clamp(min=0) * SLICE
        length = torch.where(k > 0, (n - base).clamp(max=SLICE), 0)
        at = torch.zeros(n, dtype=torch.int64)
        step = SLICE // 2
        while step:
            c = at + step
            ok = (c < length) & precedes((base + c).clamp(max=n - 1))
            at = torch.where(ok, c, at)
            step //= 2
        mark = torch.where(k > 0, pmax[(base + at).clamp(max=n - 1)],
                           torch.iinfo(torch.int64).min)
        out[:, r] = ((ka != U_INF) & (_ordered(kd) > mark).numpy())
    return out, passes


def _admit_batch(n, R, kind, seed):
    """A realistic DOM batch (lognormal 60 us one-way delays, 2 % drops,
    deadlines at send + 120 us), the 1/64 tie grid (15 % drops), or a
    realistic batch whose receivers drop everything; 3 % infinite
    deadlines, and with R >= 3 the last receiver drops everything."""
    rng = np.random.default_rng(seed)
    if kind == "grid":
        d = rng.integers(0, 4 * 64, n) / 64.0
        a = rng.integers(0, 6 * 64, (n, R)) / 64.0
        a[rng.random((n, R)) < 0.15] = np.inf
    else:
        send = np.sort(rng.uniform(0, n / 2e5, n))
        d = send + 120e-6
        a = send[:, None] + rng.lognormal(np.log(60e-6), 0.6, (n, R))
        a[rng.random((n, R)) < (1.0 if kind == "dropped" else 0.02)] = np.inf
    d[rng.random(n) < 0.03] = np.inf
    if R >= 3:
        a[:, -1] = np.inf
    return d, a


def _pallas_admit_padded(d, a):
    """`dom_admit_pallas` in interpret mode, handed its inputs padded to the
    power-of-two length it pads to itself (+inf deadline and arrival: never
    admitted, never a watermark), so that calls of one padded length share
    one compile."""
    n = d.size
    n_pad = 1 << max(0, (n - 1).bit_length())
    dp = np.full(n_pad, np.inf)
    dp[:n] = d
    ap = np.full((n_pad, a.shape[1]), np.inf)
    ap[:n] = a
    return _pallas_admit(dp, ap)[:n]


@pytest.mark.pallas
@pytest.mark.parametrize("n,R,kind", [
    (1, 1, "realistic"), (1, 5, "grid"),
    (1023, 3, "realistic"), (1024, 3, "grid"),
    (1024, 1, "realistic"), (1024, 1, "dropped"),
    (1025, 5, "realistic"), (1025, 5, "grid"),
    (16384, 3, "realistic"), (16384, 3, "grid")])
def test_admit_small_route_schedule_matches_pallas_numpy_and_plain(n, R,
                                                                   kind):
    """The small route's schedule, bit for bit, against the numpy oracle,
    the Pallas kernel (interpret mode, float64) and the plain version: n at
    and around one 1024-message slice and the 16384 bucket, R in {1, 3, 5},
    ties, drops, infinite deadlines, an all-dropped receiver."""
    d, a = _admit_batch(n, R, kind, seed=n * 10 + R)
    got, passes = _small_route_twin(d, a)
    np.testing.assert_array_equal(got, dom_admit_watermark_np(d, a))
    np.testing.assert_array_equal(got, _pallas_admit_padded(d, a))
    np.testing.assert_array_equal(got, _port_admit(d, a))
    for r in range(R):
        if np.isinf(a[:, r]).all():          # no finite key: no pass
            assert passes[r] == 0 and not got[:, r].any()


@pytest.mark.parametrize("kind", ["realistic", "grid"])
@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 2047, 10000, 16383,
                               16384])
def test_admit_small_route_schedule_matches_numpy_over_sizes(n, kind):
    """The same schedule against the numpy oracle and the plain version at
    R 1, 3 and 5 in one batch each (R 5 holds R 1 and 3's receivers)."""
    for R in (1, 3, 5):
        d, a = _admit_batch(n, R, kind, seed=n + R)
        got, _ = _small_route_twin(d, a)
        np.testing.assert_array_equal(got, dom_admit_watermark_np(d, a))
        np.testing.assert_array_equal(got, _port_admit(d, a))


def test_admit_small_route_passes_follow_the_compressed_span():
    """Compression takes the receiver's least finite key off and puts +inf
    one above the largest: a realistic 16384-message batch needs 7 of the
    8 passes, keys on one binade's quarter grid one, equal keys none."""
    d, a = _admit_batch(16384, 3, "realistic", seed=0)
    assert _small_route_twin(d, a)[1] == [7, 7, 0]
    d = np.full(64, 0.5)
    a = np.full((64, 1), 0.25)
    got, passes = _small_route_twin(d, a)
    assert passes == [0] and got.all()
    d = 1.0 + (np.arange(64) % 4) / 4.0
    a = d[::-1, None].copy()
    got, passes = _small_route_twin(d, a)
    assert passes == [1]
    np.testing.assert_array_equal(got, dom_admit_watermark_np(d, a))


@pytest.mark.parametrize("n,route", [(0, "small"), (1, "small"),
                                     (16383, "small"), (16384, "small"),
                                     (16385, "onesweep"),
                                     (1_000_000, "onesweep")])
def test_admit_route_by_size(n, route):
    """One cluster a receiver up to the data plane's 16384-message bucket,
    the onesweep sort above it."""
    assert admit_mod.admit_route(n) == route
    assert (n <= admit_mod.SMALL_MAX) == (route == "small")


@pytest.mark.parametrize("n", [100, 16384, 16385])
def test_admit_cpu_tensors_count_no_launch_on_either_route(n):
    before = (admit_mod.launches, admit_mod.launches_small,
              admit_mod.launches_onesweep)
    d, a = _admit_batch(n, 3, "realistic", seed=n)
    got = admit_mod.dom_admit(torch.as_tensor(d), torch.as_tensor(a))
    np.testing.assert_array_equal(got.numpy(), dom_admit_watermark_np(d, a))
    assert (admit_mod.launches, admit_mod.launches_small,
            admit_mod.launches_onesweep) == before


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


@pytest.mark.pallas
@pytest.mark.parametrize("kind", ["ties", "all_masked", "all_inf",
                                  "negative", "subnormals"])
def test_release_edge_inputs_match_pallas(kind):
    """The card tests' edge inputs, at the reference's kernel: the plain
    version equals `dom_release_pallas` in interpret mode."""
    n = 64
    d = {"ties": np.full(n, 0.25),
         "all_masked": RNG.uniform(0, 1, n),
         "all_inf": np.full(n, np.inf),
         "negative": -RNG.integers(0, 8, n) / 4.0,
         "subnormals": RNG.choice([5e-324, 1e-310, -5e-324, 2.2e-308], n),
         }[kind]
    admitted = (np.zeros(n, bool) if kind == "all_masked"
                else RNG.random(n) < 0.8)
    for now in (np.inf, 0.5, -0.25):
        order, count = _port_release(d, admitted, now)
        p_order, p_count = _pallas_release(d, admitted, now)
        assert count == p_count
        np.testing.assert_array_equal(order, p_order)
    if kind == "all_masked":
        assert count == 0 and (order == -1).all()


def test_release_signed_zeros_tie_by_id():
    """+0.0 and -0.0 share a key (the reference's TPU keys put -0.0 first):
    ties by id, as numpy's stable argsort."""
    d = RNG.choice([0.0, -0.0, 1e-300, -1e-300], 64)
    admitted = RNG.random(64) < 0.8
    for now in (0.0, -0.0, np.inf):
        order, count = _port_release(d, admitted, now)
        want, k = _stable_release_oracle(d, admitted, now)
        assert count == k
        np.testing.assert_array_equal(order[:k], want)
        assert (order[k:] == -1).all()


@pytest.mark.parametrize("n,route", [(0, "small"), (1, "small"),
                                     (16383, "small"), (16384, "small"),
                                     (16385, "onesweep"),
                                     (1 << 24, "onesweep")])
def test_release_route_by_size(n, route):
    """One block up to the data plane's 16384-lane bucket, onesweep above."""
    assert release_mod.release_route(n) == route
    assert (n <= release_mod.SMALL_MAX) == (route == "small")


def test_onesweep_scratch_sizes():
    """The work area: per segment 8 digit histograms of 256 words and 8
    tile counters, one released count, then two look-back banks of 256
    words a 4096-key tile and segment; the scratch adds two u64 key and
    two u32 id buffers."""
    header = 8 * 256 + 8
    assert release_mod.onesweep_work_words(0, 1) == header + 1
    for length, tiles in ((1, 1), (4096, 1), (4097, 2), (16385, 5),
                          (1 << 24, 4096)):
        assert release_mod.onesweep_work_words(length, 1) == \
            header + 1 + 2 * tiles * 256
    # dom_admit's main shape: 3 receivers of 2 x 16384 events
    assert release_mod.onesweep_work_words(2 * 16384, 3) == \
        3 * header + 1 + 2 * 3 * 8 * 256
    n = 16385
    assert release_mod.onesweep_scratch_bytes(n) == \
        24 * n + 4 * (header + 1 + 2 * 5 * 256)


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


def _qkv(S=16, Hq=4, Hk=2, D=64, dtype=torch.float32):
    mk = lambda *shape: torch.as_tensor(                 # noqa: E731
        RNG.standard_normal(shape, dtype=np.float32)).to(dtype)
    return mk(2, S, Hq, D), mk(2, S, Hk, D), mk(2, S, Hk, D)


def test_flash_attention_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = fa_mod.launches
    q, k, v = _qkv()
    assert torch.equal(fa_mod.flash_attention(q, k, v, window=4),
                       fa_mod.flash_attention_plain(q, k, v, window=4))
    assert torch.equal(ops.attention(q, k, v, causal=False),
                       fa_mod.flash_attention_plain(q, k, v, causal=False))
    assert fa_mod.launches == before


def test_flash_attention_launcher_refuses_cpu_tensors():
    q, k, v = _qkv(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention_cuda(q, k, v)


def test_flash_attention_wrapper_validates_inputs():
    q, k, v = _qkv()
    with pytest.raises(ValueError):                 # 4 query heads, 3 KV heads
        fa_mod.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1),
                               v[:, :, :1].expand(-1, -1, 3, -1))
    with pytest.raises(ValueError):                 # k and v differ
        fa_mod.flash_attention(q, k, v[:, :8])
    with pytest.raises(ValueError):                 # head dims differ
        fa_mod.flash_attention(q, k[..., :32], v[..., :32])
    with pytest.raises(TypeError):                  # mixed dtypes
        fa_mod.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):                 # not [B, S, H, D]
        fa_mod.flash_attention(q[0], k[0], v[0])


def test_lm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import init_params, zero_cache

    cfg = smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        zero_cache(cfg, 1, 8)
