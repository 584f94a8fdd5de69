"""Preemption dry run: host microseconds per placement in every node's dry
run (victim selection), from the program's span preemption.filter; in the
preempt cell one placement is one preemption (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_pop_us(info, ["preemption.filter"])
