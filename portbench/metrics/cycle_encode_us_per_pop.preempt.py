"""Encode layer: host microseconds per placement in the preemption loop's
per-cycle encode, from the program's span "Encoding the pod against the
cluster snapshot" (one cycle per preemption, and one more) (moves
placements_per_s)."""

from portbench import spans

ENCODE_SPAN = "Encoding the pod against the cluster snapshot"


def read(info):
    return spans.per_pop_us(info, [ENCODE_SPAN])
