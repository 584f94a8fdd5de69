"""Host runtime: mean ms per answer of garbage-collector pauses, charged to the program's spans (gc_s) (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.charged_ms(info, "gc_s")
