"""Encode layer: mean ms per answer in encode_problem, from ClusterCapacity.cycle_seconds (moves placements_per_s)."""


def read(info):
    return info.phase_ms("encode")
