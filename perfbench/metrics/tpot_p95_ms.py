"""95th percentile over the window's requests of (done - first token) /
(n_out - 1) (ms)."""

from perfbench import readers


def read(rec):
    return readers.tpot_ms(rec, 95)
