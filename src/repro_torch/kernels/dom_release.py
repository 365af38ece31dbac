"""Deadline-ordered release of the DOM early buffer: kernel, plain version,
wrapper.

Port of `repro/kernels/dom_release.py` (the Pallas kernel
`dom_release_pallas`, body `_dom_release_kernel`). Given deadlines [n] f64,
admitted [n] bool and a clock ``now``, it returns the ids of the released
messages (admitted and deadline <= now) in stable deadline order -- ties by
id -- padded with -1, plus their count.

The kernel (``csrc/dom_release.cu``) masks 64-bit time keys and runs a
stable 8-pass LSD radix sort with the id as payload. It is memory-bound:
the least traffic is 9n bytes read (deadline, admitted flag) and 4n
written (order). The plain version is a masked stable `torch.sort` of the
same keys.

The wrapper dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.timekeys import KEY_TOP, time_sort_keys

# Launches of the CUDA kernel through `dom_release` (counted per call).
launches = 0


def dom_release_plain(deadlines: torch.Tensor, admitted: torch.Tensor,
                      clock_now: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked stable argsort of the deadline keys (the kernel's oracle)."""
    n = deadlines.shape[0]
    now = torch.tensor(clock_now, dtype=torch.float64, device=deadlines.device)
    keys = time_sort_keys(deadlines)
    released = admitted.to(torch.bool) & (keys <= time_sort_keys(now))
    masked = torch.where(released, keys, KEY_TOP)
    order = torch.sort(masked, stable=True).indices.to(torch.int32)
    count = released.sum(dtype=torch.int32)
    seq = torch.arange(n, device=deadlines.device)
    return torch.where(seq < count, order, -1), count


def _check(deadlines: torch.Tensor, admitted: torch.Tensor) -> None:
    if deadlines.dtype != torch.float64 or deadlines.dim() != 1:
        raise TypeError("deadlines must be a 1-d float64 tensor")
    if admitted.shape != deadlines.shape:
        raise ValueError(f"admitted {tuple(admitted.shape)} does not match "
                         f"deadlines {tuple(deadlines.shape)}")
    if admitted.device != deadlines.device:
        raise ValueError("deadlines and admitted are on different devices")


def dom_release_cuda(deadlines: torch.Tensor, admitted: torch.Tensor,
                     clock_now: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global launches
    _check(deadlines, admitted)
    if deadlines.device.type != "cuda":
        raise ValueError("dom_release_cuda needs CUDA tensors")
    lib = build.library("dom_release")
    fn = lib.dom_release_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                   ctypes.c_int] + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    dev = deadlines.device
    n = deadlines.shape[0]
    d = deadlines.contiguous()
    adm = admitted.to(torch.bool).contiguous()
    order = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    ka = torch.empty(n, dtype=torch.int64, device=dev)
    kb = torch.empty_like(ka)
    va = torch.empty(n, dtype=torch.int32, device=dev)
    vb = torch.empty_like(va)
    hist = torch.empty(256 * max(1, -(-n // build.TILE)),
                       dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(d.data_ptr(), adm.data_ptr(), float(clock_now), n,
              order.data_ptr(), count.data_ptr(), ka.data_ptr(),
              kb.data_ptr(), va.data_ptr(), vb.data_ptr(), hist.data_ptr(),
              stream)
    build.check(lib, "dom_release", code)
    launches += 1
    return order, count


def dom_release(deadlines: torch.Tensor, admitted: torch.Tensor,
                clock_now: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Release order + count; the plain version on CPU, the kernel on CUDA."""
    _check(deadlines, admitted)
    if deadlines.device.type == "cpu":
        return dom_release_plain(deadlines, admitted, clock_now)
    return dom_release_cuda(deadlines, admitted, clock_now)


__all__ = ["dom_release", "dom_release_plain", "dom_release_cuda"]
