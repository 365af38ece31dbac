"""Port of `repro/core/hashing.py`: the incremental set hash of the paper's
S8.1, the per-key commutative hashes of S8.2, and the key -> group routing.

The paper XORs SHA-1 digests of <deadline, client-id, request-id> into a
running hash over the *set* of log entries; since logs are ordered by
deadline, set equality implies sequence equality. The algebra is kept and
the digest swapped, in two widths as in the reference:

* 64 bits, numpy (`entry_hash_np`, `IncrementalHash`, `PerKeyHashTable`):
  the splitmix64 mix the protocol path uses, copied as it is.
* 32 bits (`entry_hash32_np` and the torch functions below): the murmur3
  finalizer of the reference's TPU kernel, which the `inchash` kernel
  (`repro_torch.kernels.inchash`) computes on the card.

The torch functions are the reference's jnp twins. Torch's uint32 tensors
support few operations, so they compute in int64 on the low 32 bits of
their inputs (numpy's ``astype(np.uint32)``, negative inputs included) and
mask with ``& 0xFFFFFFFF`` after every multiply: a product of two values
below 2^32 wraps in signed int64 but keeps its low 32 bits, and masking
keeps every right shift on a non-negative value. They return int64 tensors
holding the 32-bit patterns, in [0, 2^32).

The crash-vector hash is XORed into every fast-reply hash (S8.1 / SA.4) to
defeat stray fast-replies after crash-recovery.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# 64-bit path (the protocol's hashes)
# ---------------------------------------------------------------------------
def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (splitmix64 finalizer)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK64
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK64
        z = z ^ (z >> np.uint64(31))
    return z


def entry_hash_np(deadline_ns: np.ndarray, client_id: np.ndarray,
                  request_id: np.ndarray) -> np.ndarray:
    """h(request): mixes the 3-tuple <deadline, client-id, request-id> (S8.1)."""
    with np.errstate(over="ignore"):
        d = _splitmix64_np(np.asarray(deadline_ns, dtype=np.uint64))
        c = _splitmix64_np(np.asarray(client_id, dtype=np.uint64) ^ np.uint64(0xA5A5A5A5A5A5A5A5))
        r = _splitmix64_np(np.asarray(request_id, dtype=np.uint64) ^ np.uint64(0x5A5A5A5A5A5A5A5A))
        return _splitmix64_np(d ^ ((c * np.uint64(0x100000001B3)) & _MASK64) ^ r)


def fold_hashes_np(hashes: np.ndarray) -> np.uint64:
    """XOR-fold a set of entry hashes -> running set hash H_n."""
    h = np.asarray(hashes, dtype=np.uint64)
    if h.size == 0:
        return np.uint64(0)
    return np.bitwise_xor.reduce(h.ravel())


def crash_vector_hash_np(cv: Sequence[int]) -> np.uint64:
    """h(crash-vector): mix each counter with its index, fold (SA)."""
    cv = np.asarray(cv, dtype=np.uint64)
    idx = np.arange(cv.size, dtype=np.uint64)
    return fold_hashes_np(_splitmix64_np(cv ^ _splitmix64_np(idx)))


class IncrementalHash:
    """The running hash a replica maintains: add/remove entries in O(1)."""

    def __init__(self, crash_vector: Sequence[int] | None = None):
        self._h = np.uint64(0)
        self._cv_h = np.uint64(0)
        if crash_vector is not None:
            self.set_crash_vector(crash_vector)

    def set_crash_vector(self, cv: Sequence[int]) -> None:
        self._cv_h = crash_vector_hash_np(cv)

    def add(self, deadline_ns: int, client_id: int, request_id: int) -> None:
        self._h ^= entry_hash_np(np.uint64(deadline_ns), np.uint64(client_id), np.uint64(request_id))

    # XOR is its own inverse: removal == addition.
    remove = add

    @property
    def value(self) -> int:
        """hash_n = H_n xor h(crash-vector)."""
        return int(self._h ^ self._cv_h)

    @property
    def set_hash(self) -> int:
        return int(self._h)

    def copy(self) -> "IncrementalHash":
        out = IncrementalHash()
        out._h = self._h
        out._cv_h = self._cv_h
        return out


class PerKeyHashTable:
    """Commutativity optimization (S8.2): one running hash per written key.

    fast-reply for a request touching keys K carries XOR of the per-key
    hashes for K only; reads contribute nothing.
    """

    def __init__(self):
        self._table: dict[int, np.uint64] = {}

    def add_write(self, key: int, deadline_ns: int, client_id: int, request_id: int) -> None:
        h = entry_hash_np(np.uint64(deadline_ns), np.uint64(client_id), np.uint64(request_id))
        self._table[key] = self._table.get(key, np.uint64(0)) ^ h

    remove_write = add_write

    def reply_hash(self, keys: Iterable[int]) -> int:
        h = np.uint64(0)
        for k in set(keys):
            h ^= self._table.get(k, np.uint64(0))
        return int(h)

    def copy(self) -> "PerKeyHashTable":
        out = PerKeyHashTable()
        out._table = dict(self._table)
        return out


# ---------------------------------------------------------------------------
# key -> group routing (sharded Nezha)
# ---------------------------------------------------------------------------
_GROUP_SALT = np.uint64(0xC0FFEE5EED5EED00)


def key_group_np(keys: np.ndarray, n_groups: int) -> np.ndarray:
    """Deterministic key -> consensus-group routing for sharded Nezha.

    Routes through the splitmix64 mix -- NOT the builtin ``hash()``, whose
    value varies with PYTHONHASHSEED -- so the assignment is identical
    across processes, restarts, and platforms. ``n_groups`` = 1 maps all
    keys to group 0 (the unsharded identity).
    """
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    keys = np.asarray(keys, dtype=np.uint64)
    if n_groups == 1:
        return np.zeros(keys.shape, dtype=np.int64)
    h = _splitmix64_np(keys ^ _GROUP_SALT)
    # 64x32-bit multiply-shift range reduction: unbiased enough for routing
    # and avoids the modulo's low-bit correlation with sequential keys.
    with np.errstate(over="ignore"):
        g = (h >> np.uint64(32)) * np.uint64(n_groups) >> np.uint64(32)
    return g.astype(np.int64)


_SPLITMIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)
_M64 = (1 << 64) - 1


def key_group(key: int, n_groups: int) -> int:
    """Scalar form of `key_group_np`, in Python integers: the same mix and
    range reduction, so the same group for every key in [0, 2^64) (a
    sharded submit routes one key at a time, and the numpy form's per-call
    cost is most of a submit's). Other keys go through the numpy form."""
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    if not isinstance(key, (int, np.integer)) or not 0 <= key <= _M64:
        return int(key_group_np(np.uint64(key), n_groups))
    if n_groups == 1:
        return 0
    z = ((int(key) ^ int(_GROUP_SALT)) + _SPLITMIX[0]) & _M64
    z = ((z ^ (z >> 30)) * _SPLITMIX[1]) & _M64
    z = ((z ^ (z >> 27)) * _SPLITMIX[2]) & _M64
    z ^= z >> 31
    return ((z >> 32) * n_groups & _M64) >> 32


# ---------------------------------------------------------------------------
# 32-bit path (the `inchash` kernel's algebra)
# ---------------------------------------------------------------------------
_MASK32 = np.uint32(0xFFFFFFFF)


def _murmur32_np(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 finalizer."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = (x * np.uint32(0x85EBCA6B)) & _MASK32
        x = x ^ (x >> np.uint32(13))
        x = (x * np.uint32(0xC2B2AE35)) & _MASK32
        x = x ^ (x >> np.uint32(16))
    return x


def entry_hash32_np(deadline_ns: np.ndarray, client_id: np.ndarray,
                    request_id: np.ndarray) -> np.ndarray:
    """32-bit mirror of the kernel's entry hash (same algebra as 64-bit)."""
    with np.errstate(over="ignore"):
        d = _murmur32_np(np.asarray(deadline_ns, dtype=np.uint32))
        c = _murmur32_np(np.asarray(client_id, dtype=np.uint32) ^ np.uint32(0xA5A5A5A5))
        r = _murmur32_np(np.asarray(request_id, dtype=np.uint32) ^ np.uint32(0x5A5A5A5A))
        return _murmur32_np(d ^ ((c * np.uint32(0x01000193)) & _MASK32) ^ r)


_M32 = 0xFFFFFFFF


def _low32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor as int64 in [0, 2^32)."""
    if x.dtype == torch.uint32:          # few ops on uint32: reinterpret
        x = x.view(torch.int32)
    return x.to(torch.int64) & _M32


def _murmur32_torch(x: torch.Tensor) -> torch.Tensor:
    """fmix32 on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def entry_hash32_torch(deadline_ns: torch.Tensor, client_id: torch.Tensor,
                       request_id: torch.Tensor) -> torch.Tensor:
    """h(request) on the tensors' device; the reference's `entry_hash_jnp`."""
    d = _murmur32_torch(_low32(deadline_ns))
    c = _murmur32_torch(_low32(client_id) ^ 0xA5A5A5A5)
    r = _murmur32_torch(_low32(request_id) ^ 0x5A5A5A5A)
    return _murmur32_torch(d ^ ((c * 0x01000193) & _M32) ^ r)


def fold_hashes_torch(hashes: torch.Tensor) -> torch.Tensor:
    """XOR-fold -> H_n over a whole set, as a 0-d tensor (torch has no XOR
    reduction: halves are folded onto each other until one value is left);
    the reference's `fold_hashes_jnp`."""
    h = _low32(hashes.reshape(-1))
    if h.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=h.device)
    while h.numel() > 1:
        half = h.numel() // 2
        rest = h[2 * half:]                  # the odd one out, if any
        h = torch.cat([h[:half] ^ h[half:2 * half], rest])
    return h[0]


def prefix_hashes_torch(hashes: torch.Tensor) -> torch.Tensor:
    """hash_i for every prefix (what the i-th fast-reply carries): an
    inclusive XOR scan over the whole array (Hillis-Steele; torch has no
    cumulative XOR); the reference's `prefix_hashes_jnp`."""
    pf = _low32(hashes)
    n, shift = pf.shape[0], 1
    while shift < n:
        pf = torch.cat([pf[:shift], pf[shift:] ^ pf[:-shift]])
        shift *= 2
    return pf


def crash_vector_hash_torch(cv: torch.Tensor) -> torch.Tensor:
    """The reference's `crash_vector_hash_jnp`, as a 0-d tensor."""
    cv = _low32(cv)
    idx = torch.arange(cv.shape[-1], dtype=torch.int64, device=cv.device)
    return fold_hashes_torch(_murmur32_torch(cv ^ _murmur32_torch(idx)))


__all__ = [
    "entry_hash_np",
    "fold_hashes_np",
    "key_group_np",
    "key_group",
    "crash_vector_hash_np",
    "IncrementalHash",
    "PerKeyHashTable",
    "entry_hash32_np",
    "entry_hash32_torch",
    "fold_hashes_torch",
    "prefix_hashes_torch",
    "crash_vector_hash_torch",
]
