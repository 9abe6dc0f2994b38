"""Bound of the attention work in the profiled slice over the device time
of the attention kernels (kernel_classes/attention*), in %."""

from perfbench import readers


def read(rec):
    return readers.roofline(rec, "attention")
