"""Port of `repro/core/hashing.py`: the stable key -> group routing hash.

Only the splitmix64 routing the workload layer uses (`key_group_np`) is
ported with the vectorized data plane; the fast-reply set hashes wait for
the `inchash` kernel.
"""
from __future__ import annotations

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (splitmix64 finalizer)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK64
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK64
        z = z ^ (z >> np.uint64(31))
    return z


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


__all__ = ["key_group_np"]
