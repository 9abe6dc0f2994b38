"""Roofline bound of all the work of the generate_device calls over their
wall, in %."""

from perfbench import readers


def read(rec):
    return readers.mfu(rec, lambda c: True)
