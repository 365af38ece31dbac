"""The runtime invariant sanitizer of the DOM data plane.

Port of `repro/core/sanitizer.py`. The reference wraps a compute tier in
`SanitizerTier`; the port has no tier object to wrap (its "tiers" are
devices), so `DomEngine` holds a `Sanitizer` beside its stages and calls
`check_epoch` on every finished `EpochState` -- after each epoch's
Deliver/Log in `run_epoch`, in `run_window`, and in the sharded backend's
batched epoch. The checks read the host arrays the epoch's single device
-> host pull has already brought back, so a sanitized run makes no extra
transfer and changes no output: it is bit for bit an unsanitized run.

Invariants (the reference's eight, with its arithmetic and messages):

  * no NaN in deadlines / arrivals / release / commit times;
  * admitted-mask within the alive-mask (a dead replica admits nothing);
  * admitted implies a finite local arrival;
  * finite release implies admitted, and release == max(deadline, arrival)
    in the receiver's local clock frame (within `_EPS` when clock-fault
    offsets shift frames);
  * release_floor respected: nothing releases before the StartView instant;
  * watermark monotonicity: per receiver, release order is deadline order
    -- capped leader entries (SD.2.4) are the documented exception,
    exempted as the epoch body's deadline cap computes them;
  * commit sanity: committed iff finite commit time; fast implies
    committed;
  * pre-stamped deadline preservation: an entry carrying a fixed global
    deadline (a sharded multi-op sub-entry) keeps it bit for bit.

Enable with `VectorizedConfig(sanitize=True)` or ``REPRO_SANITIZE`` set to
any value but "" and "0".
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from repro_torch.core.engine import DomEngine, EpochState

# fp slack for cross-frame round trips (release - off + off) under
# clock-fault offsets; exact-frame checks still compare equal because the
# body computes release as the same maximum on the same operands
_EPS = 1e-9


class SanitizerError(AssertionError):
    """An epoch violated a runtime invariant of the DOM data plane."""


class Sanitizer:
    """Per-epoch invariant checks over a finished `EpochState`.

    ``name`` is the tier the engine reports (`DomEngine.tier_name`:
    ``torch-cpu`` or ``torch-cuda``); violations are kept in
    ``violations`` for post-mortem inspection."""

    def __init__(self, name: str):
        self.name = name
        self.epochs_checked = 0
        self.violations: list[str] = []

    def check_epoch(self, s: "EpochState", eng: "DomEngine") -> None:
        """Validate one finished EpochState; raise SanitizerError naming
        every violated invariant."""
        bad: list[str] = []
        n = s.t.size
        if n == 0 or s.deadlines is None:
            self.epochs_checked += 1
            return
        d = s.deadlines
        adm = s.admitted
        rel = s.release
        off = s.clock_arr_off          # [N, R] or None
        a_loc = s.arrivals if off is None else s.arrivals + off
        rel_loc = rel if off is None else rel + off

        # capped leader entries (SD.2.4): released at arrival, slow-path
        # only -- the one documented deadline-order exception
        cap = float(getattr(eng.cfg, "deadline_cap", 0.0) or 0.0)
        capped = np.zeros(n, bool)
        if cap > 0.0:
            a_lead = a_loc[:, s.leader]
            capped = np.isfinite(a_lead) & (d > a_lead + cap)

        for label, arr in (("deadlines", d), ("arrivals", s.arrivals),
                           ("release", rel), ("commit_time", s.commit_time)):
            if arr is not None and np.isnan(arr).any():
                bad.append(f"NaN in {label}")

        if adm is not None:
            dead = ~s.alive
            if dead.any() and adm[:, dead].any():
                bad.append("admitted-mask exceeds alive-mask: dead "
                           f"replica(s) {np.flatnonzero(dead).tolist()} "
                           "admitted entries")
            ghost = adm & ~np.isfinite(a_loc)
            if ghost.any():
                bad.append(f"{int(ghost.sum())} admitted cell(s) with "
                           "non-finite local arrival")

        if rel is not None and adm is not None:
            fin_rel = np.isfinite(rel)
            if (fin_rel & ~adm).any():
                bad.append("finite release on non-admitted cell(s)")
            # release == max(deadline, local arrival) in the local frame,
            # except capped leader cells (released at arrival)
            expect = np.where(adm, np.maximum(d[:, None], a_loc), np.inf)
            mask = adm & np.isfinite(expect)
            if capped.any():
                mask[capped, s.leader] = False
            if not np.allclose(rel_loc[mask], expect[mask],
                               rtol=0.0, atol=_EPS):
                worst = float(np.max(np.abs(rel_loc[mask] - expect[mask])))
                bad.append("release != max(deadline, arrival) in the local "
                           f"frame (max |err| = {worst:.3e})")
            if s.release_floor > 0.0 and fin_rel.any() \
                    and float(rel[fin_rel].min()) < s.release_floor - _EPS:
                bad.append(
                    f"release below release_floor={s.release_floor!r}: "
                    f"min release {float(rel[fin_rel].min())!r}")
            # watermark monotonicity: per receiver, release order is
            # deadline order among admitted entries (local frame)
            for r in range(a_loc.shape[1]):
                ok = adm[:, r] & np.isfinite(rel_loc[:, r])
                if capped.any() and r == s.leader:
                    ok &= ~capped
                if ok.sum() < 2:
                    continue
                order = np.lexsort((d[ok], rel_loc[ok, r]))
                ds = d[ok][order]
                if (np.diff(ds) < 0).any():
                    bad.append(f"receiver {r}: release order violates "
                               "deadline order "
                               f"({int((np.diff(ds) < 0).sum())} pair(s))")

        # pre-stamped deadline preservation: the dl > 0 override is applied
        # LAST in the body, so the finished deadline must be the fixed
        # global value exactly (bitwise)
        if s.pre_deadline is not None:
            fixed = s.pre_deadline > 0.0
            wrong = fixed & (d != s.pre_deadline)
            if wrong.any():
                bad.append(
                    f"{int(wrong.sum())} pre-stamped entr(ies) stamped off "
                    "their fixed global deadline (max |err| = "
                    f"{float(np.max(np.abs(d[wrong] - s.pre_deadline[wrong]))):.3e})")

        if s.committed is not None and s.commit_time is not None:
            if (s.committed != np.isfinite(s.commit_time)).any():
                bad.append("committed mask != finite(commit_time)")
            if s.fast is not None and (s.fast & ~s.committed).any():
                bad.append("fast-path mark on uncommitted entry")

        self.epochs_checked += 1
        if bad:
            self.violations.extend(bad)
            raise SanitizerError(
                f"epoch invariant violation(s) [tier={self.name}, N={n}, "
                f"leader={s.leader}]: " + "; ".join(bad))


__all__ = ["Sanitizer", "SanitizerError"]
