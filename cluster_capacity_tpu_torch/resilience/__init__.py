"""Resilience: batched N-k failure sweeps with drain re-scheduling, on the
card.

Answers "does capacity survive losing a node, a zone, or k arbitrary
nodes?" — scenario enumeration and symmetric dedup in scenarios.py, the
drain + batched-headroom analyzer in analyzer.py, the CLI front-end in
cli/resilience.py, and report printing in utils/report.py.
"""

from .analyzer import (ScenarioResult, SurvivabilityReport,  # noqa: F401
                       analyze)
from .scenarios import (ZONE_TOPOLOGY_KEY, FailureScenario,  # noqa: F401
                        drain_list_scenario, random_nk_scenarios,
                        single_node_scenarios, zone_scenarios)
