"""Entry points over the CUDA kernels and their plain versions.

Port of `repro/kernels/ops.py`.
`attention` and `ssd_scan` are the dispatches the model's prefill calls: a
CPU tensor runs the plain version, a CUDA tensor launches the
flash-attention or the SSD-scan kernel. The DOM tensor forms
(`dom_admit_device`, `dom_deadline_order_device`; `repro`'s ``*_traced``
forms) take and return tensors on the caller's device and are what the
fused epoch body calls: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel; so does `inchash_device`, the fast-reply hashes of a
replica log. The host entries (`dom_admit`, `dom_deadline_order`,
`inchash`) take and return numpy arrays and run on ``device`` -- the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dom_admit import dom_admit as _admit
from repro_torch.kernels.dom_release import dom_release
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.inchash import _check as _check_columns
from repro_torch.kernels.inchash import inchash as _inchash
from repro_torch.kernels.inchash import inchash_cuda as _inchash_cuda
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window=None, q_offset: int = 0):
    """[B, S, Hq, D] x [B, Sk, Hk, D]^2 -> [B, S, Hq, D] on q's device."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """The SSD scan core on x's device: x [b, S, H, P], dt [b, S, H],
    A [H], B and C [b, S, N] -> (y [b, S, H, P], h [b, H, N, P] float32).
    The reference's `ops.ssd_scan` returns y alone; the port returns the
    final state beside it, which `models.ssm.ssd_chunked` hands on."""
    return _ssd_scan(x, dt, A, B, C, chunk=chunk)


# Early-buffer admission [N], [N, R] -> [N, R] bool on the tensors' device.
dom_admit_device = _admit


def dom_admit(deadlines, arrivals, *, device="cuda") -> np.ndarray:
    """Host entry: numpy [N], [N, R] float64 in, [N, R] bool out."""
    dev = resolve_device(device)
    d = torch.as_tensor(np.asarray(deadlines, np.float64), device=dev)
    a = torch.as_tensor(np.asarray(arrivals, np.float64), device=dev)
    return _admit(d, a).cpu().numpy()


def dom_deadline_order_device(deadlines: torch.Tensor) -> torch.Tensor:
    """Stable deadline order [N] -> int64 [N] on the deadlines' device.

    With every message admitted and the clock at +inf the early-buffer drain
    is the plain stable deadline sort: ties by id, non-finite deadlines at
    the tail, always a permutation of [0, N)."""
    n = deadlines.shape[0]
    adm = torch.ones(n, dtype=torch.bool, device=deadlines.device)
    order, _ = dom_release(deadlines, adm, float("inf"))
    return order.to(torch.int64)


def dom_deadline_order(deadlines, *, device="cuda") -> np.ndarray:
    """Host entry: ``np.argsort(deadlines, kind="stable")`` via dom_release
    (non-finite deadlines sort last); int64 indices."""
    d = np.asarray(deadlines, np.float64)
    if d.size == 0:
        return np.zeros(0, np.int64)
    dt = torch.as_tensor(d, device=resolve_device(device))
    return dom_deadline_order_device(dt).cpu().numpy()


# Fast-reply hashes: three int64 [n] columns -> (h, prefix) uint32 [n] on
# the columns' device.
inchash_device = _inchash


def inchash(deadline_ns, client_id, request_id, *,
            device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Host entry: numpy integer columns in (their low 32 bits are hashed),
    (h, prefix) np.uint32 [n] out.

    On the card: the three columns staged in one pinned [3, n] buffer and
    sent in one non-blocking copy, h and prefix written into one [2, n]
    buffer and pulled back in one copy (into a new array, so the result
    aliases nothing a later call writes). Columns that are int64 and
    contiguous are not copied on the host before the staging."""
    dev = resolve_device(device)
    cols = [np.ascontiguousarray(x, dtype=np.int64)
            for x in (deadline_ns, client_id, request_id)]
    tensors = [torch.from_numpy(x) for x in cols]
    if dev.type == "cpu":
        h, prefix = _inchash(*tensors)
        return h.numpy(), prefix.numpy()
    _check_columns(*tensors)
    n = cols[0].shape[0]
    staging = torch.empty((3, n), dtype=torch.int64, pin_memory=True)
    for row, x in zip(staging.numpy(), cols):
        # numpy's one-thread copy: torch's copy_ splits a copy this size
        # over its OpenMP threads, which can stall on a host whose cores
        # are shared
        np.copyto(row, x)
    out = torch.empty((2, n), dtype=torch.uint32, device=dev)
    _inchash_cuda(*staging.to(dev, non_blocking=True), out=out)
    h, prefix = out.cpu().numpy()
    return h, prefix


__all__ = ["resolve_device", "attention", "ssd_scan", "dom_admit", "dom_admit_device", "dom_release",
           "dom_deadline_order", "dom_deadline_order_device", "inchash",
           "inchash_device"]
