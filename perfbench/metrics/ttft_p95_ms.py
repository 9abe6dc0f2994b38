"""95th percentile over the window's requests of first token - due (ms)."""

from perfbench import readers


def read(rec):
    return readers.ttft_ms(rec, 95)
