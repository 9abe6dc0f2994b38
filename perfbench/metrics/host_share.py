"""Host time the device waited through in the window's decode-only steps:
their wall less the token fetches' waits (``serve.step``, ``serve.sync``
spans) over their wall, in %."""

from perfbench import spans


def read(rec):
    return spans.host_share(rec, spans.load(rec))
