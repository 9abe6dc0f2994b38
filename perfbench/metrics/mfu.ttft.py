"""Roofline bound of all the work of the step() calls that ran an admission
over their wall, in %."""

from perfbench import readers


def read(rec):
    return readers.mfu(rec, lambda c: c.admit)
