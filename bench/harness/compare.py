"""The comparison that decides `correct`: the system's results against the
reference's, exactly.

Each number counts what differs, and its limit is 0 (the reference's
module docstring says why agreement is bit for bit):

  log_rows_differing          synced-log rows of any group, position by
                              position (deadline, client, request, key
                              class, view, epoch batch, recovered), plus
                              the difference in length: stamping, the DOM
                              release order and the log order
  commit_rows_differing       client-visible commits (time, fast path,
                              recovered), each group's sorted by request
                              then time, plus the difference in count:
                              admission and release through the commit
                              times and paths they decide
  commit_time_gap_s           the largest gap between the two commit times
                              of one request
  spec_rows_differing         the speculative tails (each admitted,
                              uncommitted entry with the replicas that
                              admitted it) as the timed window left them,
                              plus those left after the drain: admission
                              at every replica, also where it does not
                              change a commit
  view_change_fields_differing  each completed view change's view, leader,
                              start, StartView time, merged and dropped
                              counts, plus the difference in number
  summary_fields_differing    the summary's counts, fast-path ratio and
                              latency statistics
  multiops_differing          cross-group ops whose groups or pre-stamped
                              deadline differ, or that one side lacks
"""
from __future__ import annotations

import math

import numpy as np

LIMITS = {
    "log_rows_differing": 0,
    "commit_rows_differing": 0,
    "commit_time_gap_s": 0.0,
    "spec_rows_differing": 0,
    "view_change_fields_differing": 0,
    "summary_fields_differing": 0,
    "multiops_differing": 0,
}
SUMMARY_KEYS = ("n_requests", "committed", "fast_commit_ratio",
                "median_latency", "p90_latency", "mean_latency", "batches",
                "epochs", "view_changes", "recovered_entries",
                "dropped_speculative", "cross_group_ops")


def _same(a, b) -> np.ndarray:
    """Element-wise equality that takes NaN as equal to NaN."""
    a, b = np.asarray(a), np.asarray(b)
    eq = a == b
    if a.dtype.kind == "f" and b.dtype.kind == "f":
        eq |= np.isnan(a) & np.isnan(b)
    return eq


def _rows_differing(a: dict, b: dict, cols) -> int:
    na = len(np.asarray(a[cols[0]]))
    nb = len(np.asarray(b[cols[0]]))
    m = min(na, nb)
    bad = np.zeros(m, bool)
    for c in cols:
        x, y = np.asarray(a[c])[:m], np.asarray(b[c])[:m]
        eq = _same(x, y)
        if eq.ndim > 1:
            eq = eq.all(axis=tuple(range(1, eq.ndim)))
        bad |= ~eq
    return int(bad.sum()) + abs(na - nb)


def _sorted_commits(c: dict) -> dict:
    uid = np.asarray(c["cid"], np.int64) << 32 | np.asarray(c["rid"],
                                                            np.int64)
    o = np.lexsort((np.asarray(c["t"]), uid))
    return {k: np.asarray(v)[o] for k, v in c.items()} | {"uid": uid[o]}


def compare(got: dict, want: dict) -> dict:
    """Numbers that differ between two observations (`got` judged against
    `want`), in `LIMITS`' order."""
    out = dict.fromkeys(LIMITS, 0)
    out["commit_time_gap_s"] = 0.0
    ng, nw = len(got["groups"]), len(want["groups"])
    out["log_rows_differing"] += 0 if ng == nw else 1 << 30
    for g, w in zip(got["groups"], want["groups"]):
        out["log_rows_differing"] += _rows_differing(
            g["log"], w["log"], ("deadline", "cid", "rid", "kcls", "view",
                                 "batch", "recovered"))
        cg, cw = _sorted_commits(g["commits"]), _sorted_commits(w["commits"])
        out["commit_rows_differing"] += _rows_differing(
            cg, cw, ("uid", "t", "fast", "recovered"))
        m = min(cg["uid"].size, cw["uid"].size)
        same = cg["uid"][:m] == cw["uid"][:m]
        if same.any():
            gap = np.abs(cg["t"][:m][same] - cw["t"][:m][same])
            gap = np.where(np.isnan(gap), np.inf, gap)
            out["commit_time_gap_s"] = max(out["commit_time_gap_s"],
                                           float(gap.max()))
        for tail in ("spec_window", "spec"):
            out["spec_rows_differing"] += _rows_differing(
                g[tail], w[tail], ("deadline", "cid", "rid", "kcls",
                                   "admitted"))
        vg, vw = g["view_changes"], w["view_changes"]
        bad = abs(len(vg) - len(vw)) * 6
        for a, b in zip(vg, vw):
            bad += sum(1 for k in b if not _same(a.get(k), b[k]))
        out["view_change_fields_differing"] += bad
    for k in SUMMARY_KEYS:
        if k in want["summary"] and not _same(got["summary"].get(k, math.nan),
                                              want["summary"][k]):
            out["summary_fields_differing"] += 1
    mg, mw = got["multiops"], want["multiops"]
    out["multiops_differing"] = len(set(mg) ^ set(mw)) + sum(
        1 for u in set(mg) & set(mw) if mg[u] != mw[u])
    return out


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def committed_uids(obs: dict) -> np.ndarray:
    """Requests committed to their client: a single-group request by its
    group, a cross-group op by every group it touches."""
    parts = [np.asarray(g["commits"]["cid"], np.int64) << 32
             | np.asarray(g["commits"]["rid"], np.int64)
             for g in obs["groups"]]
    u = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    uniq, counts = np.unique(u, return_counts=True)
    need = np.ones(uniq.size, np.int64)
    if obs["multiops"]:
        mu = np.asarray(list(obs["multiops"]), np.int64)
        ml = np.asarray([len(g) for g, _ in obs["multiops"].values()])
        o = np.argsort(mu)
        pos = np.clip(np.searchsorted(mu[o], uniq), 0, mu.size - 1)
        hit = mu[o][pos] == uniq
        need[hit] = ml[o][pos[hit]]
    return uniq[counts >= need]


__all__ = ["LIMITS", "compare", "verdict", "committed_uids"]
