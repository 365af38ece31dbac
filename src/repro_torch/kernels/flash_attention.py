"""Forward flash attention: kernels, plain version, wrapper.

Port of `repro/kernels/flash_attention.py` (the Pallas kernel
`flash_attention_pallas`, body `_fa_kernel`, line 77). q [B, S, Hq, D]
attends k, v [B, Sk, Hk, D]; query head h reads KV head h // (Hq / Hk)
(GQA). Scores are scaled by 1/sqrt(D) in float32, the running max and sum
and P.V accumulate in float32, masked scores contribute p = 0, so a row
with no visible key comes out 0; the output is acc / max(l, 1e-30) in q's
dtype. Query position i sits at i + q_offset; key positions at or beyond
Sk do not exist. Masks: causal (key <= query) and a sliding window
(query - key < window).

On the H100 the work is bound by operations: 4 D FLOPs per visible (query,
key) pair at 989 TFLOP/s bf16 dense, which only the tensor cores reach.
So a CUDA call takes one of two kernels (``kernel_route``):
- bf16 (the models' compute type) at D 64, 96 or 128 runs on the tensor
  cores
  (``csrc/flash_attention_sm90.cuh``): TMA copies K and V tiles through a
  ring in shared memory, two or three warpgroups of 64 query rows take
  turns to run both products with ``wgmma``, and the online softmax stays
  in registers on the float32 accumulator; the block walks only the KV
  tiles of the causal/window band. P enters the second product rounded
  to bf16. D 96 (phi-3-vision) runs as D 128 with zero columns: TMA
  fills the padding, and only 96 columns are stored.
- float32 keeps the scalar kernel (``csrc/flash_attention.cu``), float32
  FMAs at 67 TFLOP/s peak: the tensor cores take float32 only as TF32,
  which breaks the float32 route's 2e-5 tolerance. ``scalar=True`` also
  runs it on bf16 inputs, to compare the two kernels. The small head dims
  (D 16 and 32: the smoke configurations, the reference's kernel tests)
  take it in either type: their rows are narrower than one 64-column
  tensor-core atom.

The plain version is the dense O(S Sk) computation of the same function
(float32 scores [B, Hk, G, S, Sk]). The wrapper dispatches on the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor
launches a kernel (or raises). When the call needs gradients, the launch
goes through `_FlashAttentionFn`, whose backward is the plain version's;
otherwise the kernel is launched directly. While a step is recorded
(`repro_torch.kernels.record`) a fake CPU tensor takes the CUDA route,
and the launch is recorded as one op.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, record
from repro_torch.kernels.grad import needs_grad, plain_grads

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128)      # the scalar kernel's
TC_HEAD_DIMS = (64, 96, 128)           # the tensor-core kernel's (bf16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches through `flash_attention` (counted per call): of either kernel,
# and of each route on its own.
launches = 0
launches_tensor_core = 0
launches_scalar = 0


def attention_mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
                   q_offset: int, device) -> torch.Tensor:
    """[sq, sk] bool: which key each query position sees."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Dense attention with the kernel's arithmetic (its oracle)."""
    B, S, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    G = Hq // Hk
    qh = q.float().reshape(B, S, Hk, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float())
    mask = attention_mask(S, Sk, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)                                     # [B, Hk, G, S]
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    B, _, Hq, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    if k.shape[2] == 0 or Hq % k.shape[2] != 0:
        raise ValueError(f"query heads {Hq} are not a multiple of KV heads "
                         f"{k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v are on different devices")


def kernel_route(dtype: torch.dtype, D: int, scalar: bool = False) -> str:
    """The kernel a CUDA call on ``dtype`` inputs of head dim ``D`` takes:
    bf16 at a tensor-core head dim the tensor cores; float32, D 16 or 32,
    or anything with ``scalar`` the scalar kernel."""
    return "tensor_core" if (dtype == torch.bfloat16 and D in TC_HEAD_DIMS
                             and not scalar) else "scalar"


def tensor_map_args(t: torch.Tensor) -> tuple[int, ...]:
    """The 4-D TMA tensor map of a contiguous [B, S, H, D] tensor as the
    tensor-core launch takes it: the dims innermost first (D, H, S, B),
    then the byte strides of dims 1-3. A row at or past S lies outside
    dim 2, so a tile that reaches past the sequence reads zeros there,
    never the next sequence's rows."""
    B, S, H, D = t.shape
    e = t.element_size()
    return (D, H, S, B, D * e, H * D * e, S * H * D * e)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0,
                         scalar: bool = False) -> torch.Tensor:
    """Launch a CUDA kernel on PyTorch's current stream (no sync): the
    tensor-core kernel for bf16, the scalar one for float32 or with
    ``scalar`` (to compare the two on bf16; see `kernel_route`)."""
    global launches, launches_tensor_core, launches_scalar
    _check(q, k, v)
    on_card = q.device.type == "cuda"
    if not on_card and not record.recording():
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                        f"not {q.dtype}")
    D = q.shape[3]
    which = kernel_route(q.dtype, D, scalar)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims {HEAD_DIMS}, "
                         f"not {D}")
    B, S, Hq, _ = q.shape
    _, Sk, Hk, _ = k.shape
    if not on_card:
        return record.launch(
            "flash_attention", flash_attention_plain, (q, k, v),
            dict(causal=causal, window=window, q_offset=q_offset),
            flops=attention_flops(B, S, Sk, Hq, D, causal=causal,
                                  window=window, q_offset=q_offset),
            nbytes=q.element_size() * D * (2 * B * S * Hq + 2 * B * Sk * Hk))
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs contiguous, 16-byte "
                         "aligned q, k, v")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, not {window}")
    out = torch.empty_like(q)
    if B * S * Hq == 0:
        return out
    lib = build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    masks = (int(causal), 0 if window is None else int(window), int(q_offset))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if which == "tensor_core":
        fn = lib.flash_attention_tc_launch
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.POINTER(ctypes.c_ulonglong)] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        maps = [(ctypes.c_ulonglong * 7)(*tensor_map_args(t)) for t in (q, k)]
        fn.restype = ctypes.c_int
        code = fn(*ptrs, *maps, *masks, 1.0 / math.sqrt(D), stream)
    else:
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        code = fn(*ptrs, B, S, Sk, Hq, Hk, D, DTYPES[q.dtype], *masks,
                  1.0 / math.sqrt(D), stream)
    build.check(lib, "flash_attention", code)
    launches += 1
    if which == "tensor_core":
        launches_tensor_core += 1
    else:
        launches_scalar += 1
    return out


class _FlashAttentionFn(torch.autograd.Function):
    """The kernel under autograd. The forward launches it (the output is
    written through ctypes, so it carries no graph of its own); the backward
    recomputes the plain version from the saved q, k, v -- only those, not
    the plain version's dense [B, Hk, G, S, Sk] graph -- and returns
    autograd's gradients of it. The reference has no backward kernel
    either: its gradients are jnp autodiff of the same function."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset)
        return flash_attention_cuda(q, k, v, **ctx.masks)

    @staticmethod
    def backward(ctx, grad_out):
        return (*plain_grads(flash_attention_plain, ctx.saved_tensors,
                             grad_out, ctx.masks), None, None, None)


def flash_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             q_offset: int = 0) -> torch.Tensor:
    """`flash_attention_cuda` with gradients: the kernel's forward, the
    plain version's backward (`_FlashAttentionFn`)."""
    return _FlashAttentionFn.apply(q, k, v, causal, window, q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention; the plain version on CPU, the kernel on CUDA -- under
    autograd when the call needs gradients (`needs_grad`), else launched
    directly."""
    _check(q, k, v)
    masks = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cpu" and not record.recording():
        return flash_attention_plain(q, k, v, **masks)
    if needs_grad(q, k, v):
        return flash_attention_autograd(q, k, v, **masks)
    return flash_attention_cuda(q, k, v, **masks)


def attention_flops(B: int, S: int, Sk: int, Hq: int, D: int, *,
                    causal: bool, window: Optional[int] = None,
                    q_offset: int = 0) -> int:
    """FLOPs the visible (query, key) pairs need: 4 D each (QK^T and P.V)."""
    pairs = 0
    for i in range(S):
        pos = i + q_offset
        hi = min(pos + 1, Sk) if causal else Sk
        lo = max(pos - window + 1, 0) if window is not None else 0
        pairs += max(hi - lo, 0)
    return 4 * B * Hq * D * pairs


__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_cuda",
           "flash_attention_autograd", "kernel_route", "tensor_map_args",
           "attention_mask", "attention_flops", "NEG_INF"]
