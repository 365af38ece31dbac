"""The one-shot DOM release-schedule primitives, the Nezha commit
classification wrapper and the Fig 1-3 reordering metrics, on torch.

Port of `repro/core/vectorized.py`. Admission comes in two roles, as in
the reference:

  oracle      `dom_release_schedule` -- the exact O(N^2) replay of the
              early-buffer semantics, message by message in stable arrival
              order with an [N] carry of admitted deadlines per receiver.
              Kept as the property oracle for tiny instances and as the
              chunk solver of the legacy `dom_release_schedule_chunked`.
              It launches no kernel.
  production  the watermark formulation: each receiver's 2N-event stream
              -- a test of message i at its arrival a_i and a watermark
              update at its candidate release max(d_i, a_i) -- is ordered
              by (time, aux) with aux = (class * N + i) * 2 + kind (class 0
              when d_i > a_i, else 1; kind 0 test, 1 update), and i is
              admitted iff d_i exceeds the exclusive prefix max of the
              finite deadlines before its test and a_i is finite. On the
              card that is the `dom_admit` kernel, on the CPU its plain
              version (`dom_admit_watermark_np`, `dom_admit_watermark_torch`,
              `dom_release_schedule_watermark`).

`nezha_commit_times` runs the watermark schedule and then
`repro_torch.core.engine.classify_commits` (the stable deadline order from
the `dom_release` kernel) as one float64 program with one device -> host
pull. `reordering_score_np` and `multicast_reordering` are host code, as
in the reference; `dom_reordering` admits through the kernel.

The entry points take and return numpy arrays and run on ``device``: the
card unless the caller asks for the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import _pull, classify_commits_device
from repro_torch.kernels.dom_admit import (
    dom_admit_plain as dom_admit_watermark_torch,
)
from repro_torch.kernels.ops import dom_admit_device, resolve_device

_INF = float("inf")


@dataclass
class VecDomParams:
    percentile: float = 50.0
    beta: float = 3.0
    clamp_d: float = 200e-6
    window: int = 1000


def _upload(deadlines, arrivals, device):
    dev = resolve_device(device)
    d = torch.as_tensor(np.asarray(deadlines, np.float64), device=dev)
    a = torch.as_tensor(np.asarray(arrivals, np.float64), device=dev)
    return d, a


# ---------------------------------------------------------------------------
# DOM release schedule: the exact oracle
# ---------------------------------------------------------------------------
def _exact_admission(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Exact early-buffer admission of [N] deadlines at [N, R] arrivals.

    Each receiver processes its messages in stable arrival order; message
    m is admitted iff d_m > max{d_j : admitted(j), a_j < a_m, d_j <= a_m}
    -- larger than every deadline already *released* when m arrives -- and
    a_m is finite. The receivers run side by side; the carry holds each
    receiver's admitted deadlines (+inf where none) by arrival rank."""
    N, R = a.shape
    order = torch.sort(a, dim=0, stable=True).indices          # [N, R]
    d_by_arr = d[order]
    a_by_arr = a.gather(0, order)
    carry = torch.full((N, R), _INF, dtype=torch.float64, device=a.device)
    admit_by_arr = torch.zeros((N, R), dtype=torch.bool, device=a.device)
    for i in range(N):
        a_i = a_by_arr[i]
        d_i = d_by_arr[i]
        released = torch.where(torch.isfinite(carry) & (carry <= a_i),
                               carry, -_INF)
        w = released.max(dim=0).values
        admit = (d_i > w) & torch.isfinite(a_i)
        carry[i] = torch.where(admit, d_i, _INF)
        admit_by_arr[i] = admit
    admitted = torch.zeros((N, R), dtype=torch.bool, device=a.device)
    return admitted.scatter_(0, order, admit_by_arr)


def _release_times(d: torch.Tensor, a: torch.Tensor,
                   admitted: torch.Tensor) -> torch.Tensor:
    return torch.where(admitted, torch.maximum(d[:, None], a), _INF)


def dom_release_schedule(deadlines, arrivals, *,
                         device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Per-receiver DOM early-buffer semantics, exact (the O(N^2) oracle).

    Args:
      deadlines: [N] message deadlines (global synchronized time).
      arrivals:  [N, R] arrival time of each message at each receiver
                 (+inf = dropped).

    Returns (numpy, float64 throughout):
      admitted:  [N, R] bool -- entered the early-buffer.
      release:   [N, R] release time (inf if not admitted/dropped).

    A message is admitted iff its deadline exceeds the largest deadline
    already *released* at its arrival; admitted messages release at
    max(deadline, arrival), in deadline order. N steps of O(N R) work:
    for tiny instances only."""
    d, a = _upload(deadlines, arrivals, device)
    admitted = _exact_admission(d, a)
    return tuple(_pull([admitted, _release_times(d, a, admitted)]))


# ---------------------------------------------------------------------------
# Watermark admission (production path, O(N log N))
# ---------------------------------------------------------------------------
def dom_admit_watermark_np(deadlines, arrivals, *,
                           device="cuda") -> np.ndarray:
    """Event-ordered watermark admission: [N], [N, R] -> [N, R] bool
    (numpy in and out), through the `dom_admit` kernel on the card or its
    plain version on the CPU."""
    d, a = _upload(deadlines, arrivals, device)
    return dom_admit_device(d, a).cpu().numpy()


def dom_release_schedule_watermark(deadlines, arrivals, *, device="cuda"
                                   ) -> tuple[np.ndarray, np.ndarray]:
    """O(N log N) admission + release times (numpy in and out): admission
    through `dom_admit`, release = where(admitted, max(d, a), inf) in
    float64, both pulled to the host in one transfer.

    Exact w.r.t. `dom_release_schedule`, including duplicate deadlines,
    late arrivals and dropped receivers."""
    d, a = _upload(deadlines, arrivals, device)
    admitted = dom_admit_device(d, a)
    return tuple(_pull([admitted, _release_times(d, a, admitted)]))


def dom_release_schedule_chunked(deadlines: np.ndarray, arrivals: np.ndarray,
                                 chunk: int = 2048, *, device="cuda"
                                 ) -> tuple[np.ndarray, np.ndarray]:
    """Chunked (deadline-sorted) variant for large N.  LEGACY.

    Superseded by `dom_release_schedule_watermark` (O(N log N), no chunk
    tuning, no halo blow-up under heavy reordering); kept as the baseline
    the reference measures speedups against.

    Each chunk is solved exactly (`dom_release_schedule` on ``device``),
    extended by a *halo* of later-deadline messages whose deadlines fall
    within the maximum observed arrival lateness of the chunk's tail --
    those are the only later messages that can be released before a chunk
    message arrives and reject it. Across chunks the released-deadline
    watermark carries forward."""
    order = np.argsort(deadlines, kind="stable")
    inv = np.argsort(order, kind="stable")
    d_sorted = deadlines[order]
    a_sorted = arrivals[order]
    N, R = arrivals.shape
    fin_a = np.where(np.isfinite(a_sorted), a_sorted, -np.inf)
    max_late = max(0.0, float(np.max(fin_a - d_sorted[:, None], initial=0.0)))
    admitted = np.zeros((N, R), dtype=bool)
    release = np.full((N, R), np.inf)
    watermark = np.full((R,), -np.inf)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        # halo: later-deadline messages that could reject a chunk member
        hi_ext = int(np.searchsorted(d_sorted, d_sorted[hi - 1] + max_late,
                                     side="right"))
        hi_ext = min(max(hi_ext, hi), N)
        adm, _ = dom_release_schedule(d_sorted[lo:hi_ext],
                                      a_sorted[lo:hi_ext], device=device)
        adm = adm[: hi - lo]
        # Apply the carried watermark: a message also needs deadline > the
        # largest deadline released in prior chunks *before its arrival*.
        bad = d_sorted[lo:hi, None] <= watermark[None, :]
        adm = adm & ~bad
        rel = np.where(adm, np.maximum(d_sorted[lo:hi, None], a_sorted[lo:hi]),
                       np.inf)
        admitted[lo:hi] = adm
        release[lo:hi] = rel
        fin = np.isfinite(rel)
        if fin.any():
            watermark = np.maximum(
                watermark,
                np.max(np.where(fin, d_sorted[lo:hi, None], -np.inf), axis=0))
    return admitted[inv], release[inv]


# ---------------------------------------------------------------------------
# Nezha commit classification
# ---------------------------------------------------------------------------
def nezha_commit_times(
    deadlines: np.ndarray,          # [N] request deadlines (proxy-stamped)
    arrivals: np.ndarray,           # [N, R] request arrival at each replica
    reply_owd: np.ndarray,          # [N, R] replica->proxy reply delay
    leader: int,
    f: int,
    mod_owd: Optional[np.ndarray] = None,   # [N, R] leader->follower log-mod delay
    leader_batch_delay: float = 50e-6,
    key_ids: Optional[np.ndarray] = None,   # [N] commutativity class per request
    *,
    device="cuda",
) -> dict:
    """Classify each request's commit path and commit time at the proxy.

    The watermark schedule (`dom_admit`), then `classify_commits` over the
    stable deadline order (`dom_release`): one launch of each kernel on the
    card, and one device -> host pull of every output. ``key_ids`` enables
    the paper's commutativity relaxation (S8.2): requests hash-conflict
    only within their key class.

    Returns a dict of numpy arrays: commit_time[N], fast[N], committed[N],
    admitted[N, R], release[N, R]."""
    d, a = _upload(deadlines, arrivals, device)
    dev = d.device
    admitted = dom_admit_device(d, a)
    release = _release_times(d, a, admitted)

    def up(x, dtype=np.float64):
        return None if x is None else torch.as_tensor(
            np.asarray(x, dtype), device=dev)

    commit_t, fast, committed = classify_commits_device(
        d, a, admitted, release, up(reply_owd), leader, f,
        mod_owd=up(mod_owd), leader_batch_delay=leader_batch_delay,
        key_ids=up(key_ids, np.int64))
    outs = _pull([commit_t, fast, committed, admitted, release])
    return dict(zip(("commit_time", "fast", "committed", "admitted",
                     "release"), outs))


# ---------------------------------------------------------------------------
# Reordering score (LIS via patience counting on the host)
# ---------------------------------------------------------------------------
def reordering_score_np(ref_ranks: np.ndarray) -> float:
    """1 - LIS/len over an array of reference ranks (see sim.network)."""
    import bisect

    tails: list = []
    for x in ref_ranks.tolist():
        i = bisect.bisect_left(tails, x)
        if i == len(tails):
            tails.append(x)
        else:
            tails[i] = x
    if ref_ranks.size == 0:
        return 0.0
    return (1.0 - len(tails) / ref_ranks.size) * 100.0


def multicast_reordering(owd: np.ndarray, send_times: np.ndarray) -> float:
    """Fig 1-2 metric: reordering of receiver 2 w.r.t. receiver 1.

    owd: [N, 2] one-way delays; send_times: [N].
    """
    t1 = send_times + owd[:, 0]
    t2 = send_times + owd[:, 1]
    order1 = np.argsort(t1, kind="stable")
    rank1 = np.empty_like(order1)
    rank1[order1] = np.arange(len(order1))
    order2 = np.argsort(t2, kind="stable")
    return reordering_score_np(rank1[order2])


def dom_reordering(owd: np.ndarray, send_times: np.ndarray,
                   deadlines: np.ndarray, *, device="cuda") -> float:
    """Fig 3: reordering of the *released* sequences under DOM (admission
    through the `dom_admit` kernel on the card)."""
    arrivals = send_times[:, None] + owd
    admitted, release = dom_release_schedule_watermark(deadlines, arrivals,
                                                       device=device)
    both = admitted[:, 0] & admitted[:, 1]
    r1, r2 = release[both, 0], release[both, 1]
    order1 = np.argsort(r1, kind="stable")
    rank1 = np.empty_like(order1)
    rank1[order1] = np.arange(len(order1))
    order2 = np.argsort(r2, kind="stable")
    return reordering_score_np(rank1[order2])


__all__ = [
    "VecDomParams",
    "dom_release_schedule",
    "dom_release_schedule_chunked",
    "dom_release_schedule_watermark",
    "dom_admit_watermark_np",
    "dom_admit_watermark_torch",
    "nezha_commit_times",
    "multicast_reordering",
    "dom_reordering",
    "reordering_score_np",
]
