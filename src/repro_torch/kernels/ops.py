"""DOM entry points over the CUDA kernels and their plain versions.

Port of the DOM half of `repro/kernels/ops.py`. The tensor forms
(`dom_admit_device`, `dom_deadline_order_device`; `repro`'s ``*_traced``
forms) take and return tensors on the caller's device and are what the
fused epoch body calls: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel. The host entries (`dom_admit`, `dom_deadline_order`)
take and return numpy arrays and run on ``device`` -- the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dom_admit import dom_admit as _admit
from repro_torch.kernels.dom_release import dom_release


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


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


__all__ = ["resolve_device", "dom_admit", "dom_admit_device", "dom_release",
           "dom_deadline_order", "dom_deadline_order_device"]
