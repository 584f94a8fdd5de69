"""The work of one placement step with PodTopologySpread's soft score
live, counted from a cell's pod description and shapes (not from the
program's launch tables): roofline.py's step plus the soft rows' per-node
work (the domain presence behind topoSize, the score's lookup,
multiply-add and rounding, the masked min and max, the normalisation and
the count commit to the chosen node's domain) and their planes (each
row's domain ids, countable mask and resident counts, the ignored mask,
the carried counts).

A row is one ScheduleAnyway constraint: on the hostname key it reads the
node's own count (its residents plus the clones placed there), on any
other key its domain's carried count, which a clone that matches the
row's selector commits at every step.
"""

from __future__ import annotations

from typing import List, Tuple

from . import roofline
from .spread_soft import HOSTNAME_KEY, SOFT, selector_matches

Row = Tuple[bool, bool]          # (on the hostname key, the clone counts)


def spread_shape(pod: dict) -> Tuple[int, List[Row]]:
    """(hard spreads, soft rows) of one flat pod description
    (reference/cluster.make_pod's): its `spread` entries and the
    constraints of its `spec`."""
    spec = pod.get("spec") or {}
    hard = len(pod.get("spread") or [])
    rows = []
    for c in spec.get("topologySpreadConstraints") or []:
        if (c.get("whenUnsatisfiable") or "DoNotSchedule") != SOFT:
            hard += 1
            continue
        rows.append((c.get("topologyKey") == HOSTNAME_KEY,
                     selector_matches(c.get("labelSelector"),
                                      pod.get("labels") or {})))
    return hard, rows


def ss_ops(rows: List[Row]) -> int:
    """The soft rows' float operations per node per step."""
    if not rows:
        return 0
    ops = 2                                  # scored and not ignored
    for host, counts in rows:
        ops += 1 if host else 3              # host size; domain presence
        ops += 4 + (1 if host and counts else 0)   # count, mul, add, sum
        if counts and not host:
            ops += 9                         # the chosen domain, commit
    ops += 1 + 3                             # round, masked min and max
    ops += 8                                 # normalise, weight, total
    return ops


def ss_planes(rows: List[Row]) -> Tuple[int, int]:
    """(planes read, planes written) once a solve, per node."""
    if not rows:
        return 0, 0
    carried = sum(1 for host, counts in rows if counts and not host)
    return 3 * len(rows) + 1 + carried, carried


def least_seconds(nodes: int, resources: int, hard_spreads: int,
                  steps: int, rows: List[Row], kind: str = "") -> dict:
    """roofline.least_seconds with the soft rows' work added."""
    peak = roofline.peak_for(kind)
    per_node = roofline.step_ops(resources, hard_spreads) + ss_ops(rows)
    flops = per_node * nodes * steps
    read, written = ss_planes(rows)
    moved = roofline.step_bytes(nodes, resources, hard_spreads, steps) + \
        4 * nodes * (read + written)
    t_ops = flops / peak["f32_flops"]
    t_bytes = moved / peak["hbm_bytes"]
    return {"seconds": max(t_ops, t_bytes), "flops": flops, "bytes": moved,
            "bound": "operations" if t_ops >= t_bytes else "bytes"}
