"""DOM early-buffer admission per receiver: kernel, plain version, wrapper.

Port of `repro/kernels/dom_admit.py` (the Pallas kernel `dom_admit_pallas`,
body `_dom_admit_kernel`). Deadlines [N] f64 and arrivals [N, R] f64
(+inf = dropped) give admitted [N, R] bool: the watermark admission of
`repro/core/vectorized.py`. The plain version here (two stable sorts plus
`torch.cummax`) is re-exported by `repro_torch.core.vectorized` as
`dom_admit_watermark_torch`.

The kernel (``csrc/dom_admit.cu``, grid over tiles x receivers) lays the 2N
events of each receiver out directly in aux order with one integer scan,
sorts them stably on the 64-bit time key alone with the onesweep radix
sort that ``dom_release`` uses above one block (a segment a receiver),
takes the prefix max as a tile scan plus a scan of tile carries, and
scatters each test's verdict back to message order. It is memory-bound:
the least traffic is 8N + 8RN bytes read (deadlines, arrivals) and RN
written (admitted).

The wrapper dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dom_release import onesweep_work_words

# Launches of the CUDA kernel through `dom_admit` (counted per call).
launches = 0


def dom_admit_plain(deadlines: torch.Tensor,
                    arrivals: torch.Tensor) -> torch.Tensor:
    """Event-ordered watermark admission. [N], [N, R] f64 -> [N, R] bool.

    The (time, aux) lexsort is two stable sorts (aux, then time) and the
    prefix max is `torch.cummax`, batched over receivers. Non-finite inputs
    are read as +inf first, exactly as the kernel's time keys read them;
    for every other input the result equals the reference's numpy oracle
    `dom_admit_watermark_np` bit for bit."""
    N, R = arrivals.shape
    dev = arrivals.device
    if N == 0:
        return torch.zeros((0, R), dtype=torch.bool, device=dev)
    inf = torch.inf
    d = torch.where(torch.isfinite(deadlines), deadlines, inf)
    a = torch.where(torch.isfinite(arrivals), arrivals, inf).T     # [R, N]
    idx = torch.arange(N, device=dev)
    times = torch.cat([a, torch.maximum(d[None, :], a)], dim=1)     # [R, 2N]
    cls = torch.where(d[None, :] > a, 0, N)
    aux = torch.cat([((N + idx) * 2).expand(R, N), (cls + idx) * 2 + 1],
                    dim=1)
    by_aux = torch.sort(aux, dim=1, stable=True).indices
    by_time = torch.sort(torch.gather(times, 1, by_aux), dim=1,
                         stable=True).indices
    order = torch.gather(by_aux, 1, by_time)                       # [R, 2N]
    contrib = torch.where(torch.isfinite(d), d, -inf)
    vals = torch.cat([torch.full((N,), -inf, dtype=d.dtype, device=dev),
                      contrib])[order]
    runmax = torch.cummax(vals, dim=1).values
    excl = torch.cat([torch.full((R, 1), -inf, dtype=d.dtype, device=dev),
                      runmax[:, :-1]], dim=1)
    is_test = order < N
    m = torch.where(is_test, order, 0)
    ok = is_test & (d[m] > excl) & torch.isfinite(torch.gather(a, 1, m))
    out = torch.zeros((R, N + 1), dtype=torch.bool, device=dev)
    out.scatter_(1, torch.where(is_test, order, N), ok)   # updates -> slot N
    return out[:, :N].T.contiguous()


def _check(deadlines: torch.Tensor, arrivals: torch.Tensor) -> None:
    if deadlines.dtype != torch.float64 or arrivals.dtype != torch.float64:
        raise TypeError("deadlines and arrivals must be float64")
    if deadlines.dim() != 1 or arrivals.dim() != 2 \
            or arrivals.shape[0] != deadlines.shape[0]:
        raise ValueError(f"expected deadlines [N] and arrivals [N, R], got "
                         f"{tuple(deadlines.shape)} and "
                         f"{tuple(arrivals.shape)}")
    if arrivals.device != deadlines.device:
        raise ValueError("deadlines and arrivals are on different devices")


def dom_admit_cuda(deadlines: torch.Tensor,
                   arrivals: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global launches
    _check(deadlines, arrivals)
    if deadlines.device.type != "cuda":
        raise ValueError("dom_admit_cuda needs CUDA tensors")
    lib = build.library("dom_admit")
    fn = build.bind(lib, "dom_admit_launch",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int] + [ctypes.c_void_p] * 10)
    dev = deadlines.device
    n, R = arrivals.shape
    d = deadlines.contiguous()
    a = arrivals.contiguous()
    admitted = torch.empty((n, R), dtype=torch.bool, device=dev)
    events = R * 2 * n
    ka = torch.empty(events, dtype=torch.int64, device=dev)
    kb = torch.empty_like(ka)
    va = torch.empty(events, dtype=torch.int32, device=dev)
    vb = torch.empty_like(va)
    nte = max(1, -(-2 * n // build.TILE))
    ntm = max(1, -(-n // build.TILE))
    work = torch.empty(onesweep_work_words(2 * n, R), dtype=torch.int32,
                       device=dev)
    tile_count = torch.empty(R * ntm, dtype=torch.int32, device=dev)
    early_total = torch.empty(R, dtype=torch.int32, device=dev)
    tile_max = torch.empty(R * nte, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(d.data_ptr(), a.data_ptr(), n, R, admitted.data_ptr(),
              ka.data_ptr(), kb.data_ptr(), va.data_ptr(), vb.data_ptr(),
              work.data_ptr(), tile_count.data_ptr(), early_total.data_ptr(),
              tile_max.data_ptr(), stream)
    build.check(lib, "dom_admit", code)
    launches += 1
    return admitted


def dom_admit(deadlines: torch.Tensor, arrivals: torch.Tensor) -> torch.Tensor:
    """Admission [N, R] bool; the plain version on CPU, the kernel on CUDA."""
    _check(deadlines, arrivals)
    if deadlines.device.type == "cpu":
        return dom_admit_plain(deadlines, arrivals)
    return dom_admit_cuda(deadlines, arrivals)


__all__ = ["dom_admit", "dom_admit_plain", "dom_admit_cuda"]
