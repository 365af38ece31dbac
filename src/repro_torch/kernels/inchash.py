"""Fast-reply hashes of an appended replica log (paper S8.1): kernel, plain
version, wrapper.

Port of `repro/kernels/inchash.py` (the Pallas kernel `inchash_pallas`,
body `_inchash_kernel`). For n log entries (deadline_ns, client_id,
request_id), it returns the 32-bit murmur entry hash h [n] of each entry's
low 32 bits and the running prefix XOR of the h [n] -- the hash the i-th
fast reply carries.

Inputs are three 1-d int64 tensors of equal length on one device (the log's
columns; other strides are copied contiguous). Outputs are two
``torch.uint32`` tensors holding the 32-bit patterns (two rows of one
[2, n] buffer). An empty log returns two empty tensors and launches
nothing. The reference's ``block`` only tiles its scan and does not change
the result, so there is no such argument here.

The kernel (``csrc/inchash.cu``) is one launch, a single-pass scan with a
decoupled look-back over 4096-entry tiles: each tile hashes its entries in
registers, publishes its XOR aggregate, takes the XOR of the tiles before
it from their status words and writes h and prefix once. It is
memory-bound and moves the least traffic, 24n bytes read and 8n written.
Its look-back state lives in a persistent work area on the device (see
`_work_area`), so a call is one stream operation, needs no host sync and
replays correctly from a CUDA graph. The plain version is
`repro_torch.core.hashing`'s torch functions.

The wrapper dispatches on the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

# Launches of the CUDA kernel through `inchash` (counted per call).
launches = 0

# As in csrc/inchash.cu: entries per tile; u32 words before the status
# words of the work area; status words the last block sweeps a call; bits
# of the generation tag in a status word.
TILE = 4096
HEADER_WORDS = 4
SWEEP = 512
TAG_BITS = 30
MIN_CAP = 128           # status words of a new work area, at least

# The work areas, by (device index, stream handle), and the areas they
# replaced, which a captured CUDA graph may still use.
_areas: dict[tuple[int, int], torch.Tensor] = {}
_retired: list[torch.Tensor] = []
_areas_lock = threading.Lock()

# argtypes of inchash_launch: (d, c, r, n, h, prefix, work, cap, stream)
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
    [ctypes.c_int, ctypes.c_void_p]


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the uint32 patterns (through int32:
    torch's uint32 tensors support few conversions)."""
    return x.to(torch.int32).view(torch.uint32)


def inchash_plain(deadline_ns: torch.Tensor, client_id: torch.Tensor,
                  request_id: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, prefix) as uint32 tensors, from the torch hash functions (the
    kernel's oracle)."""
    # imported here: `repro_torch.core` imports the engine, which imports
    # `kernels.ops`, which imports this module
    from repro_torch.core.hashing import (entry_hash32_torch,
                                          prefix_hashes_torch)

    h = entry_hash32_torch(deadline_ns, client_id, request_id)
    return _u32(h), _u32(prefix_hashes_torch(h))


def _check(deadline_ns: torch.Tensor, client_id: torch.Tensor,
           request_id: torch.Tensor) -> None:
    d, c, r = deadline_ns, client_id, request_id   # chained: cheap per call
    if not (d.dtype == c.dtype == r.dtype == torch.int64
            and d.dim() == c.dim() == r.dim() == 1):
        raise TypeError("deadline_ns, client_id and request_id must be 1-d "
                        "int64 tensors")
    if not d.shape[0] == c.shape[0] == r.shape[0]:
        raise ValueError(f"columns differ in length: "
                         f"{[x.shape[0] for x in (d, c, r)]}")
    if not d.device == c.device == r.device:
        raise ValueError("the columns are on different devices")


def _work_area(dev: torch.device, stream: int,
               tiles: int) -> tuple[torch.Tensor, int]:
    """The look-back work area of (device, stream), with room for at least
    ``tiles`` status words, and its capacity in status words.

    Made (zeroed, on the stream) at a stream's first call and grown the
    same way when a call needs more tiles than it holds; otherwise a call
    touches no host state. The replaced area is kept: a graph captured
    with it goes on using it. Each stream has its own area, so calls on
    two streams may run at once; calls on one stream are ordered. A graph
    keeps the area of the stream it was captured on, so replays of graphs
    captured on one stream must not overlap each other."""
    key = (dev.index, stream)
    with _areas_lock:
        area = _areas.get(key)
        if area is None or (area.shape[0] - HEADER_WORDS) // 2 < tiles:
            if area is not None:
                _retired.append(area)
            cap = max(MIN_CAP, 1 << (tiles - 1).bit_length())
            area = torch.zeros(HEADER_WORDS + 2 * cap, dtype=torch.int32,
                               device=dev)
            _areas[key] = area
    return area, (area.shape[0] - HEADER_WORDS) // 2


def inchash_cuda(deadline_ns: torch.Tensor, client_id: torch.Tensor,
                 request_id: torch.Tensor, *, out: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream: one stream
    operation, no host sync.

    ``out``, a contiguous uint32 [2, n] tensor on the columns' device,
    receives h and prefix (a new one is made without it); the result is
    its two rows. The look-back state is in a work area per (device,
    stream) (`_work_area`): calls on one stream are ordered, and a call
    replayed from a CUDA graph is correct with whatever its captured
    inputs then hold. A stream's first call, and the first call that
    needs more tiles than its area holds, also zeroes a new area; capture
    a call after such a one on the capture stream to keep the graph at
    one operation."""
    global launches
    _check(deadline_ns, client_id, request_id)
    dev = deadline_ns.device
    if dev.type != "cuda":
        raise ValueError("inchash_cuda needs CUDA tensors")
    n = deadline_ns.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"inchash takes fewer than 2^31 entries, got {n}")
    if out is None:
        out = torch.empty((2, n), dtype=torch.uint32, device=dev)
    elif (out.dtype != torch.uint32 or out.shape != (2, n)
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous uint32 [2, {n}] tensor "
                         f"on {dev}")
    if n == 0:
        return out.unbind()
    lib = build.library("inchash")
    fn = build.bind(lib, "inchash_launch", _ARGS)
    d, c, r = (x.contiguous() for x in (deadline_ns, client_id, request_id))
    stream = torch.cuda.current_stream(dev).cuda_stream
    area, cap = _work_area(dev, stream, -(-n // TILE))
    h = out.data_ptr()
    code = fn(d.data_ptr(), c.data_ptr(), r.data_ptr(), n, h, h + 4 * n,
              area.data_ptr(), cap, stream)
    build.check(lib, "inchash", code)
    launches += 1
    return out.unbind()


def inchash(deadline_ns: torch.Tensor, client_id: torch.Tensor,
            request_id: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, prefix) uint32 [n]; the plain version on CPU, the kernel on CUDA."""
    _check(deadline_ns, client_id, request_id)
    if deadline_ns.device.type == "cpu":
        return inchash_plain(deadline_ns, client_id, request_id)
    return inchash_cuda(deadline_ns, client_id, request_id)


__all__ = ["inchash", "inchash_plain", "inchash_cuda", "TILE"]
