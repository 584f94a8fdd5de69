"""Preemption dry run: mean ms per answer building the oracle state and filtering every node for victims, from the program's span preemption.filter (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_answer_ms(info, ["preemption.filter"])
