"""Wall of the step() calls that ran only decode ticks, over those ticks (ms)."""

from perfbench import readers


def read(rec):
    return readers.ms_per_tick(rec, readers.decode_only)
