"""Kernels: least time of the traced solve's steps, PodTopologySpread's soft rows counted from the cell's pod description and shapes (reference/roofline_ss.py), over their device time, in percent (moves placements_per_s)."""

from portbench.reference import roofline_ss


def read(info):
    t = info.trace
    if t is None or not t.steps or t.solve is None or t.solve_busy_s <= 0:
        return None
    s = info.shapes
    hard, rows = roofline_ss.spread_shape(info.cell.traffic["pod"])
    least = roofline_ss.least_seconds(
        int(s["nodes"]), int(s["resources"]), hard, t.steps, rows,
        kind=str(s.get("kind", "")))
    return 100.0 * least["seconds"] / t.solve_busy_s
