"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

Port of `repro/models/moe.py`. Assignments are sorted by expert and
scattered into a fixed [E, C, d] buffer, so the expert products are three
batched matrix products over the expert axis (`torch.matmul`; the
reference leaves them to XLA outside any Pallas kernel).

Covers both MoE configurations:
  dbrx-132b    16 experts, top-4, swiglu experts
  arctic-480b  128 experts, top-2, plus a dense residual FFN in parallel

Three points where torch would otherwise part from the reference:
- `torch.topk` promises no order among equal values; `jax.lax.top_k` takes
  the lower index first. A stable descending sort does the same.
- `.at[slot].set(..., mode="drop")` drops the assignments past an
  expert's capacity; here they land in one extra row that is cut off.
- `.at[token].add(got * w)` adds a token's k contributions one after the
  other, in the sorted order (by expert), rounding to the token dtype
  after each add. `index_add_` would add them with atomics on the card, in
  an order that changes from run to run; here each token's contributions
  are summed in that fixed order instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def router(x2d: torch.Tensor, w_router: torch.Tensor):
    """x2d: [T, d] -> (probs [T, E], logits), float32."""
    logits = torch.matmul(x2d.float(), w_router.float())
    return torch.softmax(logits, dim=-1), logits


def top_k(probs: torch.Tensor, k: int):
    """The k largest of each row, largest first, ties to the lower index
    (as `jax.lax.top_k`): (values [T, k], indices [T, k])."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def _routed(x2d: torch.Tensor, w_router: torch.Tensor, k: int):
    """Router probabilities, the top-k experts and their weights
    renormalised over the k (float32)."""
    probs, _ = router(x2d, w_router)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def capacity(T: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert: T k / E times the factor, down to a multiple of
    8, at least 8 (the reference's formula, in Python floats)."""
    return max(int(T * top_k / n_experts * capacity_factor) // 8 * 8, 8)


def moe_ffn(x2d: torch.Tensor, p: dict, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25):
    """Sort-based MoE.

    x2d: [T, d]. p: {w_router [d, E], w_gate/w_up [E, d, f], w_down
    [E, f, d]}. Returns (out [T, d] in x2d's dtype, aux_loss [] float32).
    """
    T, d = x2d.shape
    E, k = n_experts, top_k
    C = capacity(T, E, k, capacity_factor)
    dev = x2d.device

    probs, top_p, top_e = _routed(x2d, p["w_router"], k)

    # Load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    ce = torch.bincount(top_e.reshape(-1), minlength=E).float() / (T * k)
    aux = E * torch.sum(me * ce)

    # ---- dispatch: sort assignments by expert (stable: token order) -------
    flat_e = top_e.reshape(-1)                                  # [T k]
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)    # E C: drop
    token_of_assign = sort_idx // k

    disp = torch.zeros((E * C + 1, d), dtype=x2d.dtype, device=dev)
    disp[slot] = x2d[token_of_assign]          # kept slots are unique
    disp = disp[:E * C].reshape(E, C, d)

    # ---- per-expert FFN (batched over the expert axis) --------------------
    g = torch.matmul(disp, p["w_gate"].to(x2d.dtype))
    u = torch.matmul(disp, p["w_up"].to(x2d.dtype))
    h = F.silu(g.float()).to(x2d.dtype) * u
    y = torch.matmul(h, p["w_down"].to(x2d.dtype)).reshape(E * C, d)

    # ---- combine: each token's k contributions, added in sorted order -----
    got = y[torch.clamp(slot, max=E * C - 1)]
    got = torch.where(keep[:, None], got, torch.zeros((), dtype=y.dtype,
                                                      device=dev))
    w = top_p.reshape(-1)[sort_idx][:, None].to(x2d.dtype)
    contrib = torch.empty((T * k, d), dtype=x2d.dtype, device=dev)
    # a token's j-th assignment in sorted order lands in row token * k + j:
    # the sort is stable, so its assignments keep their order in it
    rank = torch.empty_like(sort_idx)
    rank[torch.argsort(token_of_assign, stable=True)] = \
        torch.arange(T * k, device=dev) % k
    contrib[token_of_assign * k + rank] = got * w
    contrib = contrib.reshape(T, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out, aux


def moe_param_shapes(d: int, f: int, n_experts: int) -> dict:
    return {
        "w_router": (d, n_experts),
        "w_gate": (n_experts, d, f),
        "w_up": (n_experts, d, f),
        "w_down": (n_experts, f, d),
    }


def reference_moe(x2d: torch.Tensor, p: dict, *, n_experts: int,
                  top_k: int) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts, no capacity
    drop (tests, small shapes)."""
    _, top_p, top_e = _routed(x2d, p["w_router"], top_k)
    out = torch.zeros_like(x2d)
    for e in range(n_experts):
        g = torch.matmul(x2d, p["w_gate"][e].to(x2d.dtype))
        u = torch.matmul(x2d, p["w_up"][e].to(x2d.dtype))
        y = torch.matmul(F.silu(g.float()).to(x2d.dtype) * u,
                         p["w_down"][e].to(x2d.dtype))
        w = torch.where(top_e == e, top_p, 0.0).sum(-1)[:, None]
        out = out + y * w.to(x2d.dtype)
    return out


__all__ = ["moe_ffn", "moe_param_shapes", "reference_moe", "router",
           "top_k", "capacity"]
