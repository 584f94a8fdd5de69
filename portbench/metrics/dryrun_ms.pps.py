"""Preemption dry run: mean ms per answer in DefaultPreemption's host
dry run after the final Unschedulable cycle, from
ClusterCapacity.cycle_seconds["evaluate"] (moves placements_per_s)."""


def read(info):
    return info.phase_ms("evaluate")
