"""The set-up time: process start to the window's opening (s)."""

def read(rec):
    return rec.setup_s
