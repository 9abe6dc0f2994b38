"""Share of the window's time in step() calls that ran an admission
(a chunk or a batched prefill), in %."""

from perfbench import readers


def read(rec):
    return readers.share_of_window(rec, lambda c: c.admit)
