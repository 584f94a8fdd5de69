"""End to end: placements of all answers completed in the window over its whole time."""

from portbench import readers


def read(info):
    return readers.placements_per_s(info)
