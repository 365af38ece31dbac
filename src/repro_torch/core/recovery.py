"""Port of `repro/core/recovery.py`: MERGE-LOG over array-structured
replica state (paper SA, Alg 4), as the vectorized engine runs it.

The list-of-entries `merge_logs` oracle and the crash-vector helpers of the
event backend are not ported with the vectorized data plane.
"""
from __future__ import annotations

import math

import numpy as np


def pack_uids(cid: np.ndarray, rid: np.ndarray) -> np.ndarray:
    """(client-id, request-id) pairs packed into one int64 key per entry.

    THE uid-packing scheme: MERGE-LOG dedup, `PendingBuffer`,
    `ReplicaLogState` and the recovery delivery path all match uids through
    this one helper -- keep them on one bit layout."""
    return np.asarray(cid, np.int64) << 32 | np.asarray(rid, np.int64)


def qualified_replicas(last_normal_view: np.ndarray,
                       alive: np.ndarray) -> np.ndarray:
    """Alg 4's last-normal-view filter over array-structured replica state:
    the ViewChange senders whose logs MERGE-LOG may consult are the live
    replicas whose last normal view is maximal among the live set."""
    alive = np.asarray(alive, bool)
    lnv = np.asarray(last_normal_view)
    if not alive.any():
        raise ValueError("view change with no live replicas")
    return alive & (lnv == lnv[alive].max())


def merge_logs_vectorized(
    spec_deadline: np.ndarray,      # [M] speculative-entry deadlines
    spec_cid: np.ndarray,           # [M] client ids
    spec_rid: np.ndarray,           # [M] request ids
    spec_admitted: np.ndarray,      # [M, R] which replica logs hold the entry
    qualified: np.ndarray,          # [R] the last-normal-view filter mask
    f: int,
    synced_tail_deadline: float = -math.inf,
) -> tuple[np.ndarray, np.ndarray]:
    """MERGE-LOG over the engine's array-structured entries.

    The engine's epoch approximation keeps one shared synced prefix (every
    committed entry) plus per-replica speculative tails encoded as an
    admitted-mask over uncommitted entries, so steps 1-2 of Alg 4 reduce to
    the caller's `qualified_replicas` mask + the prefix it already holds.
    This function is steps 3-4: majority count beyond the sync-point and the
    (deadline, client-id, request-id) re-sort.

    Returns ``(merge_order, keep)``: ``keep[M]`` marks entries present in
    >= ceil(f/2)+1 qualified logs AND not behind the authoritative prefix
    (``synced_tail_deadline``), deduplicated per (client-id, request-id)
    keeping the smallest key3; ``merge_order`` indexes the kept entries in
    (deadline, client-id, request-id) order -- the order they enter the new
    leader's log.
    """
    d = np.asarray(spec_deadline, np.float64)
    cid = np.asarray(spec_cid, np.int64)
    rid = np.asarray(spec_rid, np.int64)
    adm = np.asarray(spec_admitted, bool)
    threshold = math.ceil(f / 2) + 1
    counts = adm[:, np.asarray(qualified, bool)].sum(axis=1)
    keep = (counts >= threshold) & (d >= synced_tail_deadline)
    if keep.any():
        # Dedupe by uid: a retried request may leave several speculative
        # attempts with distinct deadlines; the merged log takes the first
        # in key3 order (the rest are at-most-once duplicates). `order` is
        # key3-sorted, so np.unique's first-occurrence indices select them.
        order = np.lexsort((rid, cid, d))
        order = order[keep[order]]
        packed = pack_uids(cid[order], rid[order])
        _, first_pos = np.unique(packed, return_index=True)
        merge_order = order[np.sort(first_pos)]
        keep = np.zeros(d.size, bool)
        keep[merge_order] = True
    else:
        merge_order = np.empty(0, np.int64)
        keep = np.zeros(d.size, bool)
    return merge_order, keep


__all__ = ["merge_logs_vectorized", "pack_uids", "qualified_replicas"]
