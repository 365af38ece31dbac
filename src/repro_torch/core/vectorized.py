"""Watermark DOM admission as a float64 torch program.

Port of the production admission of `repro/core/vectorized.py`
(`dom_admit_watermark_np` / `dom_admit_watermark_jnp`): each receiver's
2N-event stream -- a test of message i at its arrival a_i and a watermark
update at its candidate release max(d_i, a_i) -- is ordered by (time, aux)
with aux = (class * N + i) * 2 + kind (class 0 when d_i > a_i, else 1;
kind 0 test, 1 update), and i is admitted iff d_i exceeds the exclusive
prefix max of the finite deadlines before its test and a_i is finite.

The float64 torch twin lives beside its kernel, as that kernel's plain
version (`repro_torch.kernels.dom_admit.dom_admit_plain`), and is
re-exported here under the reference's name.
"""
from __future__ import annotations

from repro_torch.kernels.dom_admit import (
    dom_admit_plain as dom_admit_watermark_torch,
)

__all__ = ["dom_admit_watermark_torch"]
