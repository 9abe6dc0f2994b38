"""Roofline bound of all the work of the decode-only step() calls over their
wall, in %."""

from perfbench import readers


def read(rec):
    return readers.mfu(rec, readers.decode_only)
