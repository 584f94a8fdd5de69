"""Device: share of the traced answer with no kernel or copy on the card (moves placements_per_s)."""

from portbench import readers


def read(info):
    return readers.device_idle_pct(info)
