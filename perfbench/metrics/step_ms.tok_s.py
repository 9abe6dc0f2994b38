"""(t(n) - t(1)) / (n - 1) of generate_device on the set's median call (ms)."""

def read(rec):
    return rec.step_ms
