"""Seconds of graph captures in the set-up (``graph.capture`` spans before
the window opened)."""

from perfbench import spans


def read(rec):
    return spans.capture_s(rec, spans.load(rec))
