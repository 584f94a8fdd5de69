"""Queue engine: kernels launched in the traced race's solve per pop."""

from portbench import readers


def read(info):
    return readers.launches_per_step(info)
