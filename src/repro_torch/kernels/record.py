"""A kernel as one op of a recorded step.

`repro_torch.analysis.ops.record_ops` runs a step on fake CPU tensors
under an `OpRecorder`. A wrapper that took its plain version there would
be counted as the plain version's aten ops (attention's dense scores, the
scan's chunk loop), which the card does not run. So while a recorder is
active a wrapper takes its card route, and where it would launch its
kernel it calls `launch`: the plain version gives the outputs' shapes with
its own ops muted, and the listing gets one entry for the kernel with the
FLOPs and bytes of the kernel's bound (its inputs read once, its outputs
written once). Under autograd the backward is the plain version's, on the
card as here, and is recorded op by op.
"""
from __future__ import annotations

import torch

# the active recorders, innermost last (`OpRecorder` pushes and pops itself)
RECORDERS: list = []


def recording() -> bool:
    """Whether a step is being recorded (an `OpRecorder` is active)."""
    return bool(RECORDERS)


def launch(name: str, plain, tensors: tuple, kwargs: dict, *, flops: int,
           nbytes: int):
    """``plain(*tensors, **kwargs)``, recorded as one launch of the kernel
    ``name`` doing ``flops`` and moving ``nbytes``."""
    rec = RECORDERS[-1]
    with rec.muted(), torch.no_grad():
        out = plain(*tensors, **kwargs)
    rec.add_kernel(name, tensors, out, flops=flops, nbytes=nbytes)
    return out


__all__ = ["RECORDERS", "recording", "launch"]
