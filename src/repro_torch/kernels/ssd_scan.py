"""Mamba2 SSD chunked scan: kernels, plain version, wrapper.

Port of `repro/kernels/ssd_scan.py` (the Pallas kernel `ssd_scan_pallas`,
body `_ssd_kernel`): the core of the chunked scan, without the D skip.
x [b, S, H, P], dt [b, S, H] (positive, softplus already applied),
A [H] float32 (negative), B and C [b, S, N] (one group shared by every
head). Per chunk of Q = min(chunk, S) rows and per head, with
cum = cumsum(dt A):
  y = ((C B^T) o exp(cum_q - cum_k) on the causal triangle) (dt_k x_k)
      + (C h) exp(cum_q)
  h <- exp(cum_last) h + B^T (exp(cum_last - cum_k) dt_k x_k)
All arithmetic is float32; y comes out in x's dtype, and the final state
h [b, H, N, P] float32 is returned beside it. A ragged last chunk is the
reference's zero padding (dt = 0, x = B = C = 0).

The kernel (``csrc/ssd_scan.cu``) runs the chunks in parallel: every
chunk's state increment first, with C B^T once per (batch, chunk) for all
heads; then one pass hands the state from chunk to chunk; then every
chunk's y from the state entering it. The products run on bf16 tensor
cores with float32 sums, a float32 operand split into bf16 parts. Scratch
(the chunk states, C B^T, the chunk decays, the entering states) comes
from `torch.empty` here. The bound on the H100 is bytes: each input read
once and y and h written once, at 3.35 TB/s.

The plain version follows the reference's chunked arithmetic
(`repro/models/ssm.py::ssd_chunked` without D). The wrapper dispatches on
the tensors' device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernels (or raises) -- through `_SsdScanFn`, whose backward
is the plain version's, when the call needs gradients. While a step is
recorded (`repro_torch.kernels.record`) a fake CPU tensor takes the CUDA
route, and the launch is recorded as one op.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, record
from repro_torch.kernels.grad import needs_grad, plain_grads

NEG_INF = -1e30
CHUNK_MAX = 128      # largest chunk the kernel takes
STATE_MAX = 128      # largest state size N the kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernels through `ssd_scan_cuda` (counted per call).
launches = 0


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """The chunked scan with the reference's arithmetic (the kernel's
    oracle). Returns (y [b, S, H, P] in x's dtype, h [b, H, N, P] f32)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H).float()
    Bc = B.reshape(b, nc, Q, N).float()
    Cc = C.reshape(b, nc, Q, N).float()
    cum = torch.cumsum(dtc * A.float(), dim=2)        # inclusive
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    h = torch.zeros(b, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq, cumq = (xc[:, c].float(), dtc[:, c], Bc[:, c],
                                 Cc[:, c], cum[:, c])
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)
        decay = cumq[:, :, None, :] - cumq[:, None, :, :]       # [b,Q,K,H]
        decay = torch.where(causal[None, :, :, None], decay, NEG_INF)
        M = scores[..., None] * torch.exp(decay) * dtq[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", M, xq)
        y_inter = (torch.einsum("bqn,bhnp->bqhp", cq, h)
                   * torch.exp(cumq)[..., None])
        last = cumq[:, -1, :]                                    # [b, H]
        to_end = torch.exp(last[:, None, :] - cumq) * dtq        # [b, Q, H]
        inc = torch.einsum("bkh,bkn,bkhp->bhnp", to_end, bq, xq)
        h = h * torch.exp(last)[:, :, None, None] + inc
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, nc * Q, H, P)[:, :S]
    return y, h


def _check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.dim() != 3:
        raise ValueError("ssd_scan takes x [b,S,H,P], dt [b,S,H], A [H], "
                         "B and C [b,S,N]")
    b, S, H, _ = x.shape
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} or A {tuple(A.shape)} does "
                         f"not match x {tuple(x.shape)}")
    if B.shape != C.shape or tuple(B.shape[:2]) != (b, S):
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"both be [{b}, {S}, N]")
    if S < 1 or chunk < 1:
        raise ValueError(f"ssd_scan needs S >= 1 and chunk >= 1, not S {S}, "
                         f"chunk {chunk}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("x, dt, A, B, C are on different devices")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """Launch the CUDA kernels on PyTorch's current stream (no sync).
    Returns (y [b, S, H, P] in x's dtype, h [b, H, N, P] float32)."""
    global launches
    _check(x, dt, A, B, C, chunk)
    on_card = x.device.type == "cuda"
    if not on_card and not record.recording():
        raise ValueError("ssd_scan_cuda needs CUDA tensors")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C)):
        if t.dtype not in DTYPES:
            raise TypeError(f"ssd_scan_cuda takes float32 or bfloat16 {name},"
                            f" not {t.dtype}")
    if B.dtype != C.dtype:
        raise TypeError("B and C must share one dtype")
    if A.dtype != torch.float32 or not A.is_contiguous():
        raise TypeError("A must be a contiguous float32 tensor")
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    if Q > CHUNK_MAX or N > STATE_MAX or N < 1:
        raise ValueError(f"ssd_scan_cuda takes chunks up to {CHUNK_MAX} and "
                         f"state sizes 1..{STATE_MAX}, not Q {Q}, N {N}")
    if not (x.stride(3) == 1 and x.stride(2) == P and dt.stride(2) == 1
            and B.stride(2) == 1 and C.stride(2) == 1):
        raise ValueError("ssd_scan_cuda needs x's [H, P] block, dt's last "
                         "axis and B's and C's last axis contiguous")
    if not on_card:
        return record.launch(
            "ssd_scan", ssd_scan_plain, (x, dt, A, B, C), {"chunk": chunk},
            flops=ssd_scan_flops(b, S, H, P, N, chunk),
            nbytes=ssd_scan_bytes(b, S, H, P, N, x_size=x.element_size(),
                                  bc_size=B.element_size(),
                                  dt_size=dt.element_size()))
    y = torch.empty((b, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((b, H, N, P), dtype=torch.float32, device=x.device)
    if b * H * P == 0:
        return y, h
    nc = -(-S // Q)
    q16 = -(-Q // 16) * 16
    f32 = dict(dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, H, N, P), **f32)
    gram = torch.empty((b, nc, q16, q16), **f32)
    decay = torch.empty((b, nc, H), **f32)
    # the states entering each chunk as bf16 parts: 3 for a float32 x
    # (float32 output), else 2 (`kSplit` in the source)
    parts = 3 if x.dtype == torch.float32 else 2
    enter = torch.empty((b, nc, H, parts, N, P), dtype=torch.bfloat16,
                        device=x.device)
    lib = build.library("ssd_scan")
    fn = build.bind(lib, "ssd_scan_launch",
                    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                    + [ctypes.c_int64] * 8 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
              gram.data_ptr(), decay.data_ptr(), enter.data_ptr(), b, S, H,
              P, N, Q, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
              B.stride(0), B.stride(1), C.stride(0), C.stride(1),
              DTYPES[x.dtype], DTYPES[B.dtype], DTYPES[dt.dtype], stream)
    build.check(lib, "ssd_scan", code)
    launches += 1
    return y, h


class _SsdScanFn(torch.autograd.Function):
    """The kernels under autograd. The forward launches them; the backward
    recomputes the plain version from the saved inputs and returns
    autograd's gradients of both outputs (y, h_final) for all five inputs
    -- a missing gradient of h counts as zeros. The reference has no
    backward kernel either."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        return (*plain_grads(ssd_scan_plain, ctx.saved_tensors,
                             (grad_y, grad_h), {"chunk": ctx.chunk}), None)


def ssd_scan_autograd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """`ssd_scan_cuda` with gradients: the kernels' forward, the plain
    version's backward (`_SsdScanFn`)."""
    return _SsdScanFn.apply(x, dt, A, B, C, chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """The scan; the plain version on CPU, the kernel on CUDA -- under
    autograd when the call needs gradients (`needs_grad`), else launched
    directly. Returns (y [b, S, H, P] in x's dtype, h [b, H, N, P]
    float32)."""
    _check(x, dt, A, B, C, chunk)
    if x.device.type == "cpu" and not record.recording():
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    if needs_grad(x, dt, A, B, C):
        return ssd_scan_autograd(x, dt, A, B, C, chunk=chunk)
    return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)


def ssd_scan_flops(b: int, S: int, H: int, P: int, N: int,
                   chunk: int = 128) -> int:
    """FLOPs the scan needs, 2 per multiply-add: per chunk of L valid rows,
    C B^T and (M x) over the L (L + 1) / 2 causal pairs, C h and the state
    update B^T (d x) over L rows."""
    Q = min(chunk, S)
    total = 0
    for s0 in range(0, S, Q):
        L = min(Q, S - s0)
        pairs = L * (L + 1) // 2
        total += 2 * (pairs * N + pairs * H * P + 2 * L * N * H * P)
    return b * total


def ssd_scan_bytes(b: int, S: int, H: int, P: int, N: int, *, x_size: int,
                   bc_size: int, dt_size: int) -> int:
    """Bytes the scan must move: x, dt, A, B, C read once, y (x's type)
    and the float32 final state written once."""
    return (2 * b * S * H * P * x_size + b * S * H * dt_size + 4 * H
            + 2 * b * S * N * bc_size + 4 * b * H * N * P)


__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_scan_cuda", "ssd_scan_autograd",
           "ssd_scan_flops",
           "ssd_scan_bytes", "CHUNK_MAX", "STATE_MAX"]
