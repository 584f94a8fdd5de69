"""Kernels: least time of the traced solve's steps, InterPodAffinity's per-node work and planes counted from the cell's pod descriptions and shapes (reference/roofline_ipa.py), over their device time, in percent (moves placements_per_s)."""

from portbench.reference import roofline_ipa


def read(info):
    t = info.trace
    if t is None or not t.steps or t.solve is None or t.solve_busy_s <= 0:
        return None
    s = info.shapes
    groups, planes, score = roofline_ipa.ipa_shape(
        info.cell.traffic["pod"], [info.cell.config["resident"]])
    least = roofline_ipa.least_seconds(
        int(s["nodes"]), int(s["resources"]), int(s["hard_spreads"]),
        t.steps, groups, planes, score, kind=str(s.get("kind", "")))
    return 100.0 * least["seconds"] / t.solve_busy_s
