"""Preemption dry run: host microseconds per placement in the candidate
tournament (pickOneNodeForPreemption), from the program's span
preemption.pick; in the preempt cell one placement is one preemption
(moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_pop_us(info, ["preemption.pick"])
