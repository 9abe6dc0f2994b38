"""Share of the time inside the program's calls in the profiled slice with
no kernel running, in %."""

from perfbench import readers


def read(rec):
    return readers.idle_share(rec)
