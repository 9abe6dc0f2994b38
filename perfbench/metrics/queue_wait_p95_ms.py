"""95th percentile over the window's requests of their first wait in the
queue, submit to slot taken (``req.queued`` spans), in ms."""

from perfbench import spans


def read(rec):
    return spans.phase_ms(rec, spans.load(rec), "req.queued", 95)
