"""Queue engine: host microseconds per pop waiting for a chunk's pops and halt flag to reach the host, from the program's span interleave.wait (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_pop_us(info, ["interleave.wait"])
