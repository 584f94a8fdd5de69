"""Queue engine: host microseconds per pop finding, loading and replaying the step's CUDA graphs, from the program's spans steps.load and steps.replay (moves placements_per_s)."""

from portbench import spans


def read(info):
    return spans.per_pop_us(info, ["steps.load", "steps.replay"])
