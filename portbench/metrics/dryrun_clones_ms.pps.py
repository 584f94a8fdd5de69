"""Preemption dry run: mean ms per answer making the clones of the final cycle's placements, from the program's span preemption.clones (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_answer_ms(info, ["preemption.clones"])
