"""Slow sweep, part of the scenario catalog on the port's event-driven
`nezha` backend against the reference's, at the cataloged rates:
the clock-skew cases (Appendix D) and the adversarial network family.
`test_torch_event_scenario.compare_scenario` says what is compared; the
catalog is split over four files so that the parts run in parallel.
"""
import pytest

from test_torch_event_scenario import compare_scenario

pytestmark = pytest.mark.slow

NAMES = (
    "clock-skew-leader",
    "clock-skew-leader-capped",
    "clock-skew-follower",
    "clock-skew-proxy",
    "clock-skew-proxy-capped",
    "leader-minority-partition",
    "split-brain-attempt",
    "flapping-links",
    "slow-but-alive-replica",
    "skewed-proxy",
    "ack-without-persist",
)


@pytest.mark.parametrize("name", NAMES)
def test_scenario_equals_the_reference(name):
    res, _, _ = compare_scenario(name)
    assert res.committed > 0
