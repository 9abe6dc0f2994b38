"""Rows with no live request over the rows the window's decode ticks
computed (``serve.decode`` spans, the engine's slots), in %."""

from perfbench import spans


def read(rec):
    return spans.dead_row_share(rec, spans.load(rec))
