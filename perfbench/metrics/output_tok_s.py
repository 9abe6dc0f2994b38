"""Tokens emitted inside the window over its seconds (closed loop: all
tokens of the calls made in the window over the window's start to the
last call's end)."""

def read(rec):
    return rec.tokens / rec.window_s if rec.window_s > 0 else None
