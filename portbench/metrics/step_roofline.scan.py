"""Kernels: least time of the traced solve's steps, from the cell's shapes, over their device time, in percent."""

from portbench import readers


def read(info):
    return readers.step_roofline(info)
