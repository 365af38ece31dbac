"""Fast-reply hashes of an appended replica log (paper S8.1): kernel, plain
version, wrapper.

Port of `repro/kernels/inchash.py` (the Pallas kernel `inchash_pallas`,
body `_inchash_kernel`). For n log entries (deadline_ns, client_id,
request_id), it returns the 32-bit murmur entry hash h [n] of each entry's
low 32 bits and the running prefix XOR of the h [n] -- the hash the i-th
fast reply carries.

Inputs are three 1-d int64 tensors of equal length on one device (the log's
columns; other strides are copied contiguous). Outputs are two
``torch.uint32`` tensors holding the 32-bit patterns. An empty log returns
two empty tensors and launches nothing. The reference's ``block`` only
tiles its scan and does not change the result, so there is no such
argument here.

The kernel (``csrc/inchash.cu``) is a reduce-then-scan over 2048-entry
tiles: the tile folds are scanned by one block between two tile passes. It
is memory-bound: the least traffic is 24n bytes read and 8n written. The
plain version is `repro_torch.core.hashing`'s torch functions.

The wrapper dispatches on the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Launches of the CUDA kernel through `inchash` (counted per call).
launches = 0

# entries per tile of the kernel, `TILE` in csrc/inchash.cu
TILE = 2048


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
    cols = (deadline_ns, client_id, request_id)
    if any(x.dtype != torch.int64 or x.dim() != 1 for x in cols):
        raise TypeError("deadline_ns, client_id and request_id must be 1-d "
                        "int64 tensors")
    if len({x.shape[0] for x in cols}) != 1:
        raise ValueError(f"columns differ in length: "
                         f"{[x.shape[0] for x in cols]}")
    if len({x.device for x in cols}) != 1:
        raise ValueError("the columns are on different devices")


def inchash_cuda(deadline_ns: torch.Tensor, client_id: torch.Tensor,
                 request_id: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global launches
    _check(deadline_ns, client_id, request_id)
    dev = deadline_ns.device
    if dev.type != "cuda":
        raise ValueError("inchash_cuda needs CUDA tensors")
    n = deadline_ns.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"inchash takes fewer than 2^31 entries, got {n}")
    h = torch.empty(n, dtype=torch.uint32, device=dev)
    prefix = torch.empty(n, dtype=torch.uint32, device=dev)
    if n == 0:
        return h, prefix
    lib = build.library("inchash")
    fn = lib.inchash_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    d, c, r = (x.contiguous() for x in (deadline_ns, client_id, request_id))
    tile_xor = torch.empty(-(-n // TILE), dtype=torch.uint32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(d.data_ptr(), c.data_ptr(), r.data_ptr(), n, h.data_ptr(),
              prefix.data_ptr(), tile_xor.data_ptr(), stream)
    build.check(lib, "inchash", code)
    launches += 1
    return h, prefix


def inchash(deadline_ns: torch.Tensor, client_id: torch.Tensor,
            request_id: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, prefix) uint32 [n]; the plain version on CPU, the kernel on CUDA."""
    _check(deadline_ns, client_id, request_id)
    if deadline_ns.device.type == "cpu":
        return inchash_plain(deadline_ns, client_id, request_id)
    return inchash_cuda(deadline_ns, client_id, request_id)


__all__ = ["inchash", "inchash_plain", "inchash_cuda", "TILE"]
