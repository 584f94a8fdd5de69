"""Snapshot layer: mean ms per answer building the program's ClusterSnapshot from the object lists (moves placements_per_s)."""


def read(info):
    return info.phase_ms("snapshot")
