"""Deadline-ordered release of the DOM early buffer: kernel, plain version,
wrapper.

Port of `repro/kernels/dom_release.py` (the Pallas kernel
`dom_release_pallas`, body `_dom_release_kernel`). Given deadlines [n] f64,
admitted [n] bool and a clock ``now``, it returns the ids of the released
messages (admitted and deadline <= now) in stable deadline order -- ties by
id -- padded with -1, plus their count.

The kernel (``csrc/dom_release.cu``) masks 64-bit time keys and sorts them
stably by 8-bit LSD radix passes with the id as payload, on one of two
routes (``release_route``): ``small`` up to ``SMALL_MAX`` lanes (the data
plane's bucket of ~1e4 requests) is one launch of one block that keeps the
keys in registers and shared memory and skips a pass whose digit is the
same for every key; ``onesweep`` above it is the onesweep sort shared with
``dom_admit`` (a memset, an upfront histogram kernel, eight pass kernels
with a decoupled look-back), with one scratch buffer of
``onesweep_scratch_bytes(n)``. The least traffic is 9n bytes read
(deadline, admitted flag) and 4n written (order). The plain version is a
masked stable `torch.sort` of the same keys.

The wrapper dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.timekeys import KEY_TOP, time_sort_keys

SMALL_MAX = 16384        # `SMALL_MAX` in csrc/dom_release.cu
ONESWEEP_TILE = 4096     # `OS_TILE` in csrc/common.cuh
PASSES = 8

# Launches through `dom_release` (counted per call): of either route, and
# of each route on its own.
launches = 0
launches_small = 0
launches_onesweep = 0


def release_route(n: int) -> str:
    """The kernel route for n lanes: ``small`` (one block) or ``onesweep``."""
    return "small" if n <= SMALL_MAX else "onesweep"


def onesweep_work_words(length: int, segments: int) -> int:
    """u32 words of the onesweep sort's work area (`dom::work_words`):
    the eight digit histograms and tile counters of each segment, the
    released count, and two banks of look-back status words a tile."""
    tiles = -(-length // ONESWEEP_TILE)
    return segments * (PASSES * 256 + PASSES) + 1 + 2 * segments * tiles * 256


def onesweep_scratch_bytes(n: int) -> int:
    """Bytes of the one scratch buffer an onesweep call takes: two key and
    two id buffers of n lanes and the work area (the small route takes
    none)."""
    return 24 * n + 4 * onesweep_work_words(n, 1)


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


# argtypes of the two launch functions: (deadlines, admitted, now, n, order,
# count[, scratch, scratch bytes], stream)
_SMALL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p]
_ONESWEEP_ARGS = _SMALL_ARGS[:6] + [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p]


def dom_release_cuda(deadlines: torch.Tensor, admitted: torch.Tensor,
                     clock_now: float, *, route: str | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream (no sync).

    ``route`` forces a route (``small`` takes at most SMALL_MAX lanes), to
    compare the two; by default `release_route` picks it."""
    global launches, launches_small, launches_onesweep
    _check(deadlines, admitted)
    if deadlines.device.type != "cuda":
        raise ValueError("dom_release_cuda needs CUDA tensors")
    n = deadlines.shape[0]
    route = release_route(n) if route is None else route
    if route not in ("small", "onesweep") or (route == "small"
                                              and n > SMALL_MAX):
        raise ValueError(f"no route {route!r} for n = {n}")
    lib = build.library("dom_release")
    dev = deadlines.device
    d = deadlines.contiguous()
    adm = admitted.to(torch.bool).contiguous()
    order = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (d.data_ptr(), adm.data_ptr(), float(clock_now), n,
            order.data_ptr(), count.data_ptr())
    if route == "small":
        fn = build.bind(lib, "dom_release_small_launch", _SMALL_ARGS)
        code = fn(*args, stream)
    else:
        fn = build.bind(lib, "dom_release_onesweep_launch", _ONESWEEP_ARGS)
        nbytes = onesweep_scratch_bytes(n)
        scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=dev)
        code = fn(*args, scratch.data_ptr(), nbytes, stream)
    build.check(lib, "dom_release", code)
    launches += 1
    if route == "small":
        launches_small += 1
    else:
        launches_onesweep += 1
    return order, count


def dom_release(deadlines: torch.Tensor, admitted: torch.Tensor,
                clock_now: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Release order + count; the plain version on CPU, the kernel on CUDA."""
    _check(deadlines, admitted)
    if deadlines.device.type == "cpu":
        return dom_release_plain(deadlines, admitted, clock_now)
    return dom_release_cuda(deadlines, admitted, clock_now)


__all__ = ["dom_release", "dom_release_plain", "dom_release_cuda",
           "release_route", "onesweep_scratch_bytes", "onesweep_work_words",
           "SMALL_MAX", "ONESWEEP_TILE"]
