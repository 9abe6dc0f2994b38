"""Bound of the linear work in the profiled slice over the device time of
the linear kernels (kernel_classes/linear*), in %."""

from perfbench import readers


def read(rec):
    return readers.roofline(rec, "linear")
