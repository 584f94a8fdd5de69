"""What the benchmark takes from the program under test
(cluster_capacity_tpu_torch): its entry points, run as the configuration
states, and the markers that name their phases in a profiler trace.  The
JAX package is never imported."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class Answer:
    """One whole answer: the program's results (one per template asked),
    the snapshot it built, host seconds per phase, placements made,
    whether any result came back degraded (off its entry rung), and what
    else the entry's own check_answer reads (such as each preemption's node
    and victims)."""
    results: List[object]
    snapshot: object
    phases: Dict[str, float] = field(default_factory=dict)
    placed: int = 0
    degraded: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


def profile_of(config: dict):
    """The scheduler profile the configuration states."""
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile
    p = config.get("profile") or {}
    return SchedulerProfile(
        name=p.get("name", "default-scheduler"),
        compute_dtype=p.get("compute_dtype", "float32"),
        deterministic=bool(p.get("deterministic", True)),
        percentage_of_nodes_to_score=int(
            p.get("percentage_of_nodes_to_score", 100)),
        post_filters=list(p.get("post_filters", ["DefaultPreemption"])))


def marker(name: str):
    """A named range in the profiler's trace (next to nothing when no
    profiler runs)."""
    from torch.profiler import record_function
    return record_function(name)
