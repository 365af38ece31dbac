"""Port of `repro/core/recovery.py`: crash vectors and MERGE-LOG (paper
SA, Alg 3-4).

Pure functions over replica state: the event replicas
(`repro_torch.core.replica`) run the crash-vector helpers and the
list-of-entries `merge_logs`; `merge_logs_vectorized` is the same MERGE-LOG
over array-structured replica state, as the vectorized engine runs it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.messages import LogEntry, ViewChange


def aggregate_crash_vectors(cvs: Sequence[Sequence[int]]) -> tuple:
    """Element-wise max over crash vectors (Alg 3 AGGREGATE)."""
    assert cvs, "aggregate of empty crash-vector set"
    n = len(cvs[0])
    return tuple(max(cv[i] for cv in cvs) for i in range(n))


def check_crash_vector(local_cv: Sequence[int], sender: int, msg_cv: Sequence[int]) -> bool:
    """Alg 3 CHECK-CRASH-VECTOR: False -> potential stray message (reject).

    The caller must aggregate on True (we return the decision only; callers
    update local state so the accept path stays explicit).
    """
    return not (msg_cv[sender] < local_cv[sender])


def merge_logs(view_changes: Sequence[ViewChange], f: int,
               stats: Optional[dict] = None) -> list[LogEntry]:
    """MERGE-LOG (Alg 4 lines 73-89): rebuild the new leader's log.

    1. Consider only messages with the largest last-normal-view.
    2. Copy entries up to the largest sync-point among them verbatim.
    3. Beyond the sync-point, keep entries present in >= ceil(f/2)+1 of the
       *qualified* logs.
    4. Sort by (deadline, client-id, request-id).

    view_changes must contain >= f+1 messages (incl. the new leader's own).
    ``stats``, when given, is incremented in place: ``recovered_entries``
    (candidates beyond the copied prefix that made the merged log) and
    ``dropped_speculative`` (candidates rejected -- sub-majority or behind
    the authoritative prefix).
    """
    assert len(view_changes) >= f + 1
    lnv_max = max(m.last_normal_view for m in view_changes)
    qualified = [m for m in view_changes if m.last_normal_view == lnv_max]
    # Largest sync-point (a count of synced entries) among qualified replicas.
    best = max(qualified, key=lambda m: m.sync_point)
    new_log: list[LogEntry] = list(best.log[: best.sync_point])
    synced_deadline = new_log[-1].deadline if new_log else -math.inf
    synced_uids = {e.key3 for e in new_log}

    # Candidate entries beyond the copied prefix, from all qualified logs.
    threshold = math.ceil(f / 2) + 1
    counts: dict = {}
    entry_by_key: dict = {}
    dropped = 0
    for m in qualified:
        for e in m.log:
            if e.key3 in synced_uids:
                continue  # already in the copied prefix
            if e.deadline < synced_deadline:
                # Strictly before the synced prefix but not in it: cannot be
                # committed (the prefix is authoritative); drop.
                dropped += 1
                continue
            counts[e.key3] = counts.get(e.key3, 0) + 1
            entry_by_key.setdefault(e.key3, e)
    recovered = 0
    for key3, cnt in counts.items():
        if cnt >= threshold:
            new_log.append(entry_by_key[key3])
            recovered += 1
        else:
            dropped += 1

    new_log.sort(key=lambda e: (e.deadline, e.client_id, e.request_id))
    if stats is not None:
        stats["recovered_entries"] = stats.get("recovered_entries", 0) + recovered
        stats["dropped_speculative"] = stats.get("dropped_speculative", 0) + dropped
    return new_log




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


def highest_view(replies: Sequence) -> int:
    return max(m.view_id for m in replies)


__all__ = ["aggregate_crash_vectors", "check_crash_vector", "merge_logs",
           "merge_logs_vectorized", "pack_uids", "qualified_replicas",
           "highest_view"]
