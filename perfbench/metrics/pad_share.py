"""Padded positions over the positions the window's admissions computed
(``serve.admit.batch``, ``serve.admit.chunk`` spans), in %."""

from perfbench import spans


def read(rec):
    return spans.pad_share(rec, spans.load(rec))
