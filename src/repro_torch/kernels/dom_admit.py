"""DOM early-buffer admission per receiver: kernel, plain version, wrapper.

Port of `repro/kernels/dom_admit.py` (the Pallas kernel `dom_admit_pallas`,
body `_dom_admit_kernel`). Deadlines [N] f64 and arrivals [N, R] f64
(+inf = dropped) give admitted [N, R] bool: the watermark admission of
`repro/core/vectorized.py`. The plain version here (two stable sorts plus
`torch.cummax`) is re-exported by `repro_torch.core.vectorized` as
`dom_admit_watermark_torch`. Every entry also takes G batches at once --
deadlines [G, N] and arrivals [G, N, R] give admitted [G, N, R] -- in one
launch: the G consensus groups of a sharded epoch, which the reference
runs under `jax.vmap`.

The kernel (``csrc/dom_admit.cu``) has two routes (``admit_route``).
``small``, up to ``SMALL_MAX`` messages (the data plane's bucket of ~1e4
requests), is one launch of G * R clusters of up to 16 blocks (the
fewest that hold N: ``dom_release.small_route_blocks``), one a (group,
receiver) pair, with every stage on chip: it sorts the N updates alone,
placed in aux order and stably on compressed time keys (the receiver's
least finite key taken off, so only the 8-bit passes the span needs
run), takes their prefix max, and finds by binary search how many
updates precede each test. ``onesweep`` above it lays the 2N events of
each receiver out in aux order with one integer scan, sorts them stably
on the 64-bit time key with the onesweep radix sort that ``dom_release``
uses above one cluster (a segment a (group, receiver) pair), takes the
prefix max as a tile scan plus a scan of tile carries, and scatters each
test's verdict back to message order. Both are memory-bound in
principle: the least traffic is 8N + 8RN bytes read (deadlines,
arrivals) and RN written (admitted), G times over.

The wrapper dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dom_release import onesweep_work_words

SMALL_MAX = 16384        # `SMALL_MAX` in csrc/dom_admit.cu

# Launches through `dom_admit` (counted per call): of either route, and of
# each route on its own.
launches = 0
launches_small = 0
launches_onesweep = 0


def admit_route(n: int) -> str:
    """The kernel route for n messages: ``small`` (one cluster a receiver)
    or ``onesweep``."""
    return "small" if n <= SMALL_MAX else "onesweep"


def dom_admit_plain(deadlines: torch.Tensor,
                    arrivals: torch.Tensor) -> torch.Tensor:
    """Event-ordered watermark admission. [N], [N, R] f64 -> [N, R] bool,
    or [G, N], [G, N, R] -> [G, N, R] for G batches.

    The (time, aux) lexsort is two stable sorts (aux, then time) and the
    prefix max is `torch.cummax`, batched over groups and receivers.
    Non-finite inputs are read as +inf first, exactly as the kernel's time
    keys read them; for every other input the result equals the reference's
    numpy oracle `dom_admit_watermark_np` bit for bit."""
    if deadlines.dim() == 1:
        return dom_admit_plain(deadlines[None], arrivals[None])[0]
    G, N, R = arrivals.shape
    dev = arrivals.device
    if N == 0 or G == 0:
        return torch.zeros((G, N, R), dtype=torch.bool, device=dev)
    inf = torch.inf
    d = torch.where(torch.isfinite(deadlines), deadlines, inf)[:, None, :]
    a = torch.where(torch.isfinite(arrivals), arrivals,
                    inf).transpose(1, 2)                         # [G, R, N]
    idx = torch.arange(N, device=dev)
    times = torch.cat([a, torch.maximum(d, a)], dim=2)           # [G, R, 2N]
    cls = torch.where(d > a, 0, N)
    aux = torch.cat([((N + idx) * 2).expand(G, R, N), (cls + idx) * 2 + 1],
                    dim=2)
    by_aux = torch.sort(aux, dim=2, stable=True).indices
    by_time = torch.sort(torch.gather(times, 2, by_aux), dim=2,
                         stable=True).indices
    order = torch.gather(by_aux, 2, by_time)                     # [G, R, 2N]
    contrib = torch.where(torch.isfinite(d), d, -inf)            # [G, 1, N]
    vals = torch.cat([torch.full_like(contrib, -inf), contrib], dim=2)
    vals = torch.gather(vals.expand(G, R, 2 * N), 2, order)
    runmax = torch.cummax(vals, dim=2).values
    excl = torch.cat([torch.full((G, R, 1), -inf, dtype=d.dtype, device=dev),
                      runmax[..., :-1]], dim=2)
    is_test = order < N
    m = torch.where(is_test, order, 0)
    ok = is_test & (torch.gather(d.expand(G, R, N), 2, m) > excl) \
        & torch.isfinite(torch.gather(a, 2, m))
    out = torch.zeros((G, R, N + 1), dtype=torch.bool, device=dev)
    out.scatter_(2, torch.where(is_test, order, N), ok)   # updates -> slot N
    return out[..., :N].transpose(1, 2).contiguous()


def _check(deadlines: torch.Tensor, arrivals: torch.Tensor) -> None:
    if deadlines.dtype != torch.float64 or arrivals.dtype != torch.float64:
        raise TypeError("deadlines and arrivals must be float64")
    if deadlines.dim() not in (1, 2) \
            or arrivals.dim() != deadlines.dim() + 1 \
            or arrivals.shape[:-1] != deadlines.shape:
        raise ValueError(f"expected deadlines [N] and arrivals [N, R] (or "
                         f"[G, N] and [G, N, R]), got "
                         f"{tuple(deadlines.shape)} and "
                         f"{tuple(arrivals.shape)}")
    if arrivals.device != deadlines.device:
        raise ValueError("deadlines and arrivals are on different devices")


# argtypes of the two launch functions: (deadlines, arrivals, n, R, G,
# admitted[, ka, kb, va, vb, work, tile_count, early_total, tile_max],
# stream)
_SMALL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_ONESWEEP_ARGS = _SMALL_ARGS[:6] + [ctypes.c_void_p] * 9


def dom_admit_cuda(deadlines: torch.Tensor, arrivals: torch.Tensor, *,
                   route: str | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync): one
    launch for [N], [N, R] or for all G batches of [G, N], [G, N, R].

    ``route`` forces a route (``small`` takes at most SMALL_MAX messages),
    to compare the two; by default `admit_route` picks it from N. An empty
    batch launches nothing."""
    global launches, launches_small, launches_onesweep
    _check(deadlines, arrivals)
    if deadlines.device.type != "cuda":
        raise ValueError("dom_admit_cuda needs CUDA tensors")
    G, n, R = (1, *arrivals.shape) if arrivals.dim() == 2 else arrivals.shape
    route = admit_route(n) if route is None else route
    if route not in ("small", "onesweep") or (route == "small"
                                              and n > SMALL_MAX):
        raise ValueError(f"no route {route!r} for n = {n}")
    dev = deadlines.device
    admitted = torch.empty(arrivals.shape, dtype=torch.bool, device=dev)
    if n == 0 or R == 0 or G == 0:
        return admitted
    lib = build.library("dom_admit")
    d = deadlines.contiguous()
    a = arrivals.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (d.data_ptr(), a.data_ptr(), n, R, G, admitted.data_ptr())
    if route == "small":
        fn = build.bind(lib, "dom_admit_small_launch", _SMALL_ARGS)
        code = fn(*args, stream)
    else:
        fn = build.bind(lib, "dom_admit_onesweep_launch", _ONESWEEP_ARGS)
        S = G * R                         # a segment a (group, receiver)
        events = S * 2 * n
        ka = torch.empty(events, dtype=torch.int64, device=dev)
        kb = torch.empty_like(ka)
        va = torch.empty(events, dtype=torch.int32, device=dev)
        vb = torch.empty_like(va)
        nte = max(1, -(-2 * n // build.TILE))
        ntm = max(1, -(-n // build.TILE))
        work = torch.empty(onesweep_work_words(2 * n, S), dtype=torch.int32,
                           device=dev)
        tile_count = torch.empty(S * ntm, dtype=torch.int32, device=dev)
        early_total = torch.empty(S, dtype=torch.int32, device=dev)
        tile_max = torch.empty(S * nte, dtype=torch.int64, device=dev)
        code = fn(*args, ka.data_ptr(), kb.data_ptr(), va.data_ptr(),
                  vb.data_ptr(), work.data_ptr(), tile_count.data_ptr(),
                  early_total.data_ptr(), tile_max.data_ptr(), stream)
    build.check(lib, "dom_admit", code)
    launches += 1
    if route == "small":
        launches_small += 1
    else:
        launches_onesweep += 1
    return admitted


def small_route_clusters(R: int) -> int:
    """Clusters of the small route the current card holds at once for R
    receivers (`cudaOccupancyMaxActiveClusters`); a query, not a launch."""
    lib = build.library("dom_admit")
    fn = build.bind(lib, "dom_admit_small_clusters",
                    [ctypes.c_int, ctypes.c_void_p])
    out = ctypes.c_int(0)
    build.check(lib, "dom_admit", fn(R, ctypes.addressof(out)))
    return out.value


def dom_admit(deadlines: torch.Tensor, arrivals: torch.Tensor) -> torch.Tensor:
    """Admission [N, R] (or [G, N, R]) bool; the plain version on CPU,
    the kernel (one launch) on CUDA."""
    _check(deadlines, arrivals)
    if deadlines.device.type == "cpu":
        return dom_admit_plain(deadlines, arrivals)
    return dom_admit_cuda(deadlines, arrivals)


__all__ = ["dom_admit", "dom_admit_plain", "dom_admit_cuda", "admit_route",
           "small_route_clusters", "SMALL_MAX"]
