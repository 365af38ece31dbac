"""Port of `repro/sim`: the network model, the workload driver, the
scenario catalog and the commit-trace checkers."""
from repro_torch.sim.network import (
    CloudNetwork,
    NetworkParams,
    lis_length,
    reordering_score,
)
from repro_torch.sim.scenario import (
    ClockClear,
    ClockFault,
    Crash,
    Environment,
    NetShift,
    Relaunch,
    Scenario,
    ScenarioResult,
    available_scenarios,
    get_scenario,
    run_scenario,
)
from repro_torch.sim.trace import (
    CommitTrace,
    assert_equivalent_commits,
    assert_trace_ok,
    check_equivalent_commits,
    check_trace,
    run_scenario_with_trace,
)
from repro_torch.sim.workload import Workload, WorkloadDriver

__all__ = [
    "CloudNetwork",
    "NetworkParams",
    "lis_length",
    "reordering_score",
    "Workload",
    "WorkloadDriver",
    "Environment",
    "Scenario",
    "ScenarioResult",
    "Crash",
    "Relaunch",
    "ClockFault",
    "ClockClear",
    "NetShift",
    "available_scenarios",
    "get_scenario",
    "run_scenario",
    "CommitTrace",
    "check_trace",
    "check_equivalent_commits",
    "assert_trace_ok",
    "assert_equivalent_commits",
    "run_scenario_with_trace",
]
