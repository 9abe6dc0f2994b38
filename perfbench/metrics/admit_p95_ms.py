"""95th percentile over the window's requests of their first admission,
slot taken to first token (``req.admit`` spans), in ms."""

from perfbench import spans


def read(rec):
    return spans.phase_ms(rec, spans.load(rec), "req.admit", 95)
