"""Preemption commit: host microseconds per placement in the eviction and
the incremental re-snapshot after each preemption, from the program's span
preemption.commit; in the preempt cell one placement is one preemption
(moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_pop_us(info, ["preemption.commit"])
