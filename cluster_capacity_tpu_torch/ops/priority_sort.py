"""PrioritySort (QueueSort plugin): priority desc, then queue time asc.

Reference: vendor/.../scheduler/framework/plugins/queuesort/priority_sort.go
(Less: higher spec.priority first; ties by QueuedPodInfo timestamp — here the
pod creationTimestamp stands in, since the simulator enqueues everything at
snapshot time).  Used to order multi-template sweeps the way the real queue
would interleave them.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence


def resolve_priority(pod: Mapping, priority_classes: Sequence[Mapping]) -> int:
    """Pod priority: spec.priority, else priorityClassName lookup, else the
    globalDefault class, else 0 (preemption.go resolve order)."""
    spec = pod.get("spec") or {}
    if spec.get("priority") is not None:
        return int(spec["priority"])
    name = spec.get("priorityClassName")
    default = 0
    for pc in priority_classes:
        if (pc.get("metadata") or {}).get("name") == name:
            return int(pc.get("value", 0))
        if pc.get("globalDefault"):
            default = int(pc.get("value", 0))
    return default


def sort_pods(pods: Sequence[Mapping],
              priority_classes: Sequence[Mapping] = ()) -> List[Mapping]:
    def key(pod):
        prio = resolve_priority(pod, priority_classes)
        created = ((pod.get("metadata") or {}).get("creationTimestamp")) or ""
        return (-prio, created)

    return sorted(pods, key=key)
