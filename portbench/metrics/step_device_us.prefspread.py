"""Kernels: device busy microseconds per placement step inside the traced answer's solve, PodTopologySpread's soft score live (moves placements_per_s)."""

from portbench import readers


def read(info):
    return readers.step_device_us(info)
