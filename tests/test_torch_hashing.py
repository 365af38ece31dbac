"""The port's hashes (repro_torch.core.hashing) and its `inchash` kernel's
plain version against the reference: `repro.core.hashing`, its jnp twins,
`ref.inchash_ref` and `inchash_pallas` in interpret mode.

Tolerance: exact -- every function is integer arithmetic. Inputs are made
with numpy from a seed. JAX runs without 64-bit mode here, so the reference
is handed uint32 arrays: the low 32 bits, which is what its kernel's own
``.astype(jnp.uint32)`` takes. The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py``); here the wrappers take the plain version
because the tensors lie on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hashing as jh
import repro.kernels.ref as jref
import repro_torch.core.hashing as th
import repro_torch.kernels.ref as tref
from repro.kernels.inchash import inchash_pallas
from repro_torch.core import IncrementalHash, PerKeyHashTable
from repro_torch.kernels import inchash as inchash_mod
from repro_torch.kernels import ops


def _log(n, seed):
    """A log's columns as int64: deadlines around 1.7e18 ns with full high
    bits, client ids in [0, 1000), request ids in [0, 2^40), a few
    negative values in each column."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1_600_000_000_000_000_000, 1_800_000_000_000_000_000, n)
    c = rng.integers(0, 1000, n)
    r = rng.integers(0, 2 ** 40, n)
    for col in (d, c, r):
        neg = rng.random(n) < 0.05
        col[neg] = -rng.integers(1, 2 ** 62, int(neg.sum()))
    return d, c, r


def _u32(*cols):
    return tuple(x.astype(np.uint32) for x in cols)


def _np(x):
    return np.asarray(x).astype(np.uint64)


# ---------------------------------------------------------------------------
# the 64-bit protocol hashes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_entry_hash_and_fold_equal_the_references(n):
    rng = np.random.default_rng(n)
    d, c, r = (rng.integers(0, 2 ** 64, n, dtype=np.uint64) for _ in range(3))
    got = th.entry_hash_np(d, c, r)
    np.testing.assert_array_equal(got, jh.entry_hash_np(d, c, r))
    assert got.dtype == np.uint64
    assert th.fold_hashes_np(got) == jh.fold_hashes_np(got)
    assert type(th.fold_hashes_np(got)) is np.uint64


@pytest.mark.parametrize("cv", [(), (0,), (0, 0, 0), (3, 1, 4, 1, 5),
                                (2 ** 63, 7)])
def test_crash_vector_hash_equals_the_references(cv):
    assert th.crash_vector_hash_np(cv) == jh.crash_vector_hash_np(cv)


@pytest.mark.parametrize("n_groups", [1, 2, 7, 64])
def test_key_group_equals_the_references(n_groups):
    keys = np.random.default_rng(n_groups).integers(0, 2 ** 63, 500)
    np.testing.assert_array_equal(th.key_group_np(keys, n_groups),
                                  jh.key_group_np(keys, n_groups))
    for k in keys[:20].tolist() + [0, 2 ** 64 - 1]:
        assert th.key_group(k, n_groups) == jh.key_group(k, n_groups)
    with pytest.raises(ValueError):
        th.key_group(1, 0)


def test_incremental_hash_equals_the_references():
    """add/remove/value/set_hash/copy/set_crash_vector, step by step."""
    rng = np.random.default_rng(11)
    entries = [tuple(int(v) for v in rng.integers(0, 2 ** 62, 3))
               for _ in range(40)]
    port, ref = IncrementalHash(crash_vector=(0, 1, 0)), \
        jh.IncrementalHash(crash_vector=(0, 1, 0))
    assert (port.value, port.set_hash) == (ref.value, ref.set_hash)
    for i, e in enumerate(entries):
        port.add(*e)
        ref.add(*e)
        if i % 3 == 2:
            port.remove(*entries[i - 1])
            ref.remove(*entries[i - 1])
        if i == 20:
            port.set_crash_vector((1, 1, 2))
            ref.set_crash_vector((1, 1, 2))
        assert (port.value, port.set_hash) == (ref.value, ref.set_hash)
    pc, rc = port.copy(), ref.copy()
    pc.add(*entries[0])
    rc.add(*entries[0])
    assert (pc.value, pc.set_hash) == (rc.value, rc.set_hash)
    assert (port.value, port.set_hash) == (ref.value, ref.set_hash)
    assert pc.value != port.value
    assert IncrementalHash().value == jh.IncrementalHash().value == 0


def test_per_key_hash_table_equals_the_references():
    """add_write/remove_write/reply_hash/copy, step by step."""
    rng = np.random.default_rng(12)
    port, ref = PerKeyHashTable(), jh.PerKeyHashTable()
    writes = [(int(rng.integers(0, 8)),
               *(int(v) for v in rng.integers(0, 2 ** 62, 3)))
              for _ in range(50)]
    for i, w in enumerate(writes):
        port.add_write(*w)
        ref.add_write(*w)
        if i % 4 == 3:
            port.remove_write(*writes[i - 2])
            ref.remove_write(*writes[i - 2])
        keys = rng.integers(0, 10, 3).tolist() + [3, 3]
        assert port.reply_hash(keys) == ref.reply_hash(keys)
    pc, rc = port.copy(), ref.copy()
    pc.add_write(*writes[0])
    rc.add_write(*writes[0])
    for keys in ([writes[0][0]], list(range(10)), []):
        assert pc.reply_hash(keys) == rc.reply_hash(keys)
        assert port.reply_hash(keys) == ref.reply_hash(keys)


# ---------------------------------------------------------------------------
# the 32-bit mirror and the torch twins of the jnp functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 333, 4096])
def test_32bit_mirror_equals_the_references(n):
    d, c, r = _u32(*_log(n, seed=n))
    np.testing.assert_array_equal(th._murmur32_np(d), jh._murmur32_np(d))
    got = th.entry_hash32_np(d, c, r)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jh.entry_hash32_np(d, c, r))


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 1000])
def test_torch_twins_equal_the_jnp_twins(n):
    d, c, r = _log(n, seed=n + 1)
    du, cu, ru = _u32(d, c, r)
    h = th.entry_hash32_torch(*(torch.as_tensor(x) for x in (d, c, r)))
    want = jh.entry_hash_jnp(jnp.asarray(du), jnp.asarray(cu), jnp.asarray(ru))
    assert h.dtype == torch.int64
    assert int(h.min()) >= 0 and int(h.max()) < 2 ** 32
    np.testing.assert_array_equal(_np(h), _np(want))
    np.testing.assert_array_equal(_np(h), _np(jh.entry_hash32_np(du, cu, ru)))
    hu = np.asarray(want)
    assert int(th.fold_hashes_torch(h)) == int(jh.fold_hashes_jnp(hu))
    np.testing.assert_array_equal(_np(th.prefix_hashes_torch(h)),
                                  _np(jh.prefix_hashes_jnp(hu)))
    cv = c[: n % 7 + 1]
    assert int(th.crash_vector_hash_torch(torch.as_tensor(cv))) == \
        int(jh.crash_vector_hash_jnp(jnp.asarray(cv.astype(np.uint32))))


def test_torch_twins_take_the_low_32_bits_of_any_integer_tensor():
    d, c, r = _log(64, seed=3)
    want = _np(jh.entry_hash32_np(*_u32(d, c, r)))
    low = [torch.as_tensor(x) for x in _u32(d, c, r)]
    assert low[0].dtype == torch.uint32
    for cols in ([torch.as_tensor(x) for x in (d, c, r)], low,
                 [x.view(torch.int32) for x in low]):
        np.testing.assert_array_equal(_np(th.entry_hash32_torch(*cols)), want)


def test_empty_fold_and_prefix():
    empty = torch.zeros(0, dtype=torch.int64)
    assert int(th.fold_hashes_torch(empty)) == 0
    assert th.prefix_hashes_torch(empty).shape == (0,)
    assert int(th.crash_vector_hash_torch(empty)) == \
        int(jh.crash_vector_hash_jnp(jnp.zeros(0, jnp.uint32)))


# ---------------------------------------------------------------------------
# the inchash kernel's plain version and the host entry
# ---------------------------------------------------------------------------
def _pallas(d, c, r, block):
    h, pf = inchash_pallas(*(jnp.asarray(x) for x in _u32(d, c, r)),
                           block=block, interpret=True)
    return _np(h), _np(pf)


def _check_port(d, c, r, want_h, want_pf):
    cols = [torch.as_tensor(x) for x in (d, c, r)]
    h, pf = inchash_mod.inchash_plain(*cols)
    assert h.dtype == pf.dtype == torch.uint32
    np.testing.assert_array_equal(_np(h.numpy()), want_h)
    np.testing.assert_array_equal(_np(pf.numpy()), want_pf)
    h, pf = ops.inchash(d, c, r, device="cpu")
    assert h.dtype == pf.dtype == np.uint32
    np.testing.assert_array_equal(_np(h), want_h)
    np.testing.assert_array_equal(_np(pf), want_pf)


@pytest.mark.pallas
@pytest.mark.parametrize("n,block", [(16, 16), (100, 32), (256, 64),
                                     (1000, 256), (1, 256), (255, 256),
                                     (257, 256), (333, 256), (4097, 256)])
def test_inchash_equals_the_pallas_kernel_and_the_numpy_mirror(n, block):
    """The reference's kernel-test shapes (`tests/test_kernels.py:196`) and
    ragged n around its 256-entry block, on a log with high bits set and
    negative values."""
    d, c, r = _log(n, seed=n)
    want_h, want_pf = _pallas(d, c, r, block)
    mirror = jh.entry_hash32_np(*_u32(d, c, r))
    np.testing.assert_array_equal(want_h, _np(mirror))
    np.testing.assert_array_equal(want_pf,
                                  _np(np.bitwise_xor.accumulate(mirror)))
    _check_port(d, c, r, want_h, want_pf)


def test_inchash_of_an_empty_log_equals_the_references():
    z = np.zeros(0, np.int64)
    want_h, want_pf = jref.inchash_ref(*(jnp.asarray(x.astype(np.uint32))
                                         for x in (z, z, z)))
    assert np.asarray(want_h).shape == np.asarray(want_pf).shape == (0,)
    _check_port(z, z, z, _np(want_h), _np(want_pf))


@pytest.mark.parametrize("n", [1, 300])
def test_port_oracle_equals_the_references(n):
    d, c, r = _log(n, seed=n + 5)
    got_h, got_pf = tref.inchash_ref(*(torch.as_tensor(x) for x in (d, c, r)))
    want_h, want_pf = jref.inchash_ref(*(jnp.asarray(x)
                                         for x in _u32(d, c, r)))
    np.testing.assert_array_equal(_np(got_h), _np(want_h))
    np.testing.assert_array_equal(_np(got_pf), _np(want_pf))


def test_inchash_takes_strided_columns():
    """The log's columns as views into a wider array."""
    d, c, r = _log(500, seed=8)
    table = torch.as_tensor(np.stack([d, c, r], axis=1))      # [n, 3]
    cols = [table[:, i] for i in range(3)]
    assert not cols[0].is_contiguous()
    h, pf = inchash_mod.inchash(*cols)
    want = jh.entry_hash32_np(*_u32(d, c, r))
    np.testing.assert_array_equal(_np(h.numpy()), _np(want))
    np.testing.assert_array_equal(_np(pf.numpy()),
                                  _np(np.bitwise_xor.accumulate(want)))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = inchash_mod.launches
    cols = [torch.as_tensor(x) for x in _log(50, seed=9)]
    got = inchash_mod.inchash(*cols)
    want = inchash_mod.inchash_plain(*cols)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))
    assert ops.inchash_device is inchash_mod.inchash
    assert inchash_mod.launches == before


def test_inchash_refuses_cpu_tensors_and_bad_inputs():
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        inchash_mod.inchash_cuda(x, x, x)
    with pytest.raises(TypeError):
        inchash_mod.inchash(x.to(torch.float64), x, x)
    with pytest.raises(TypeError):
        inchash_mod.inchash(x[None], x[None], x[None])
    with pytest.raises(ValueError):
        inchash_mod.inchash(x, x[:3], x)


def test_inchash_cuda_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.inchash(np.zeros(4, np.int64), np.zeros(4, np.int64),
                    np.zeros(4, np.int64))
