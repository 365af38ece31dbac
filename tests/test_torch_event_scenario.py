"""Cataloged scenarios on the port's event-driven `nezha` backend against
the reference's, and `CommitTrace.from_event_cluster`, on the CPU.

One scenario per fault family runs here through both packages'
`run_scenario_with_trace` (a crash, crash and recovery, a skewed leader
clock, a partition, a gray link) at a quarter of its cataloged rate; the
whole catalog runs at its own rates in `test_torch_event_sweep_*.py`
(marked slow: about 10 min of CPU in all), through `compare_scenario`
below.

Tolerance: bit for bit -- every key of `SCENARIO_RESULT_KEYS` and of the
raw summary (``tier`` is ``"event"`` and ``epochs`` 0 on both sides), and
every field of the commit trace: log and commit columns, stamps, clock-sync
evidence, durability events, per-replica logs and fault windows. The
findings of `check_trace` and `check_adversarial` are equal both ways (each
package's checkers on the other's trace, carried across field by field).
Per-key hashes key string keys by Python's salted `hash`, so both sides run
in one process.
"""
import dataclasses

import pytest

from repro.sim import scenario as RS
from repro.sim import trace as RT
from repro_torch.sim import scenario as PS
from repro_torch.sim import trace as PT
from test_torch_scenario import _carry, _findings, _same

FAMILIES = ("leader-crash", "crash-recovery", "clock-skew-leader",
            "leader-minority-partition", "slow-but-alive-replica")


def _scenario(mod, name: str, rate_div: float):
    sc = mod.get_scenario(name)
    if rate_div == 1:
        return sc
    w = dataclasses.replace(sc.workload,
                            rate_per_client=sc.workload.rate_per_client
                            / rate_div)
    return dataclasses.replace(sc, workload=w)


def compare_scenario(name: str, protocol: str = "nezha",
                     rate_div: float = 1):
    """Run the cataloged scenario ``name`` (its request rate divided by
    ``rate_div``; faults, environment and horizon as cataloged) on
    ``protocol`` through both packages' `run_scenario_with_trace`; assert
    the results, the raw summaries and the traces equal and the findings
    agree both ways. Returns the port's (result, trace, findings)."""
    rres, rtr = RT.run_scenario_with_trace(protocol,
                                           _scenario(RS, name, rate_div))
    pres, ptr = PT.run_scenario_with_trace(protocol,
                                           _scenario(PS, name, rate_div),
                                           device="cpu")
    _same(rres.as_dict(), pres.as_dict(), "result")
    _same(rres.raw, pres.raw, "raw")
    assert pres.tier == "event" and pres.epochs == 0
    assert type(ptr) is PT.CommitTrace
    for f in dataclasses.fields(rtr):
        _same(getattr(rtr, f.name), getattr(ptr, f.name), f.name)
    found = _findings(PT, ptr)
    assert found == _findings(RT, rtr)
    assert _findings(RT, _carry(ptr, RT.CommitTrace)) == found
    assert _findings(PT, _carry(rtr, PT.CommitTrace)) == found
    assert PT.check_equivalent_commits(ptr, _carry(rtr, PT.CommitTrace)) == []
    return pres, ptr, found


@pytest.mark.parametrize("name", FAMILIES)
def test_fault_family_scenario_equals_the_reference(name):
    """At a quarter of the cataloged rate (the slow sweep runs the catalog
    at its own rates)."""
    res, tr, found = compare_scenario(name, rate_div=4)
    sc = PS.get_scenario(name)
    assert res.committed > 0 and res.skipped_faults == 0
    assert res.applied_faults == len(sc.faults)
    assert tr.commits["t"].size == res.committed
    if "crash" in name:
        assert res.view_changes >= 1
    if sc.invariant is not None:
        # the paired invariant fires on the fault, as in the reference
        assert PT.ADVERSARIAL_CHECKS[sc.invariant](tr)
        assert res.invariant_violations >= 1
        assert res.partition_epochs + res.gray_link_epochs >= 1


def test_run_scenario_counts_faults_a_baseline_cannot_model():
    """`multipaxos` models no replica crash: `leader-crash` skips its crash
    events and counts them, as the reference does."""
    mine = PS.run_scenario("multipaxos", "leader-crash")
    theirs = RS.run_scenario("multipaxos", "leader-crash")
    _same(theirs.as_dict(), mine.as_dict())
    _same(theirs.raw, mine.raw)
    assert mine.skipped_faults == len(PS.get_scenario("leader-crash").faults)
    assert mine.committed > 0 and mine.tier == "event"


def test_the_sweep_files_cover_the_catalog():
    """The slow sweep files and the families here together run every
    cataloged scenario once."""
    import test_torch_event_sweep_clock as clock
    import test_torch_event_sweep_crash as crash
    import test_torch_event_sweep_network as network
    import test_torch_event_sweep_sync as sync

    names = [n for m in (clock, crash, network, sync) for n in m.NAMES]
    assert sorted(names) == sorted(PS.available_scenarios())
    assert len(set(names)) == len(names) == 28
