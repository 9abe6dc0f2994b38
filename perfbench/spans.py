"""What the readers of the port's own spans share (``metrics/`` files
``queue_wait_p95_ms``, ``admit_p95_ms``, ``pad_share``,
``dead_row_share``, ``host_share``, ``capture_s``).

The spans are the port's tracer's (``tinychatengine_tpu_torch/utils/
tracing.py`` names them and their two counts ``a`` and ``b``), stamped in
ns on the clock of ``time.perf_counter``, so the window's ``t_open`` and
``t_close`` select them as they are. ``load`` imports the tracer inside
the call, once the run has loaded the port; a port without one reads
None, and so does a ring that has pushed out any span. Each
reader takes the ``Record`` and the spans (``load``'s, or a list built
by hand; None reads None). The window's spans began at or after
``t_open`` and ended by ``t_close``; the window's requests are those
whose first ``req.queued`` began in it. The profiler's slice follows
the window, so none of these spans ran under it.
"""

from __future__ import annotations

from perfbench.traffic import percentile


def _ns(t: float) -> int:
    return round(t * 1e9)


def load(rec):
    """The port's spans since the run's start (``t_open - setup_s``), or
    None: no tracer in the port, or its ring has pushed out a span (the
    ring holds every span of the process until then)."""
    try:
        from tinychatengine_tpu_torch.utils import tracing
    except ImportError:
        return None
    if tracing.RECORDER.dropped:
        return None
    return tracing.RECORDER.snapshot(_ns(rec.t_open - rec.setup_s))


def window(rec, spans, *names) -> list:
    lo, hi = _ns(rec.t_open), _ns(rec.t_close)
    return [s for s in spans
            if s.name in names and lo <= s.start and s.end <= hi]


def phase_ms(rec, spans, phase: str, q: float):
    """q-th percentile over the window's requests of each one's first
    ``phase`` span (``req.queued``, ``req.admit``), in ms."""
    if spans is None:
        return None
    lo, hi = _ns(rec.t_open), _ns(rec.t_close)
    queued: dict = {}
    for s in spans:
        if s.name == "req.queued":
            queued.setdefault(s.request, s.start)
    ids = {r for r, t in queued.items() if lo <= t < hi}
    first: dict = {}
    for s in spans:
        if s.name == phase and s.request in ids:
            first.setdefault(s.request, s)
    v = [(s.end - s.start) * 1e-6 for s in first.values()]
    return percentile(v, q) if v else None


def pad_share(rec, spans):
    """Padded positions over positions computed by the window's
    admissions (batched and chunks), in %."""
    if spans is None:
        return None
    adm = window(rec, spans, "serve.admit.batch", "serve.admit.chunk")
    computed = sum(s.a for s in adm)
    return 100.0 * sum(s.a - s.b for s in adm) / computed if computed \
        else None


def dead_row_share(rec, spans):
    """Rows without a live request over the rows the window's decode
    ticks computed (the engine's slots each tick), in %."""
    if spans is None:
        return None
    engines = [s for s in spans
               if s.name == "serve.engine" and s.start <= _ns(rec.t_open)]
    if not engines:
        return None
    slots = engines[-1].a
    dec = window(rec, spans, "serve.decode")
    rows = sum(slots * s.a for s in dec)
    return 100.0 * sum((slots - s.b) * s.a for s in dec) / rows if rows \
        else None


def decode_only(s) -> bool:
    """A step that ran no admission chunk and admitted no batch."""
    return s.a == 0 and s.b == 0


def host_share(rec, spans):
    """Over the window's decode-only steps: their wall less the host's
    waits on token fetches (``serve.sync``) inside them, over their
    wall, in %."""
    if spans is None:
        return None
    steps = {s.id: s for s in window(rec, spans, "serve.step")
             if decode_only(s)}
    wall = sum(s.end - s.start for s in steps.values())
    if not wall:
        return None
    parent = {s.id: s.parent for s in spans}
    wait = 0
    for s in spans:
        if s.name != "serve.sync":
            continue
        p = s.parent
        while p and p not in steps:
            p = parent.get(p, 0)
        if p:
            wait += s.end - s.start
    return 100.0 * (wall - wait) / wall


def capture_s(rec, spans):
    """Seconds of graph captures in the set-up (before ``t_open``)."""
    if spans is None:
        return None
    lo, hi = _ns(rec.t_open - rec.setup_s), _ns(rec.t_open)
    return 1e-9 * sum(s.end - s.start for s in spans
                      if s.name == "graph.capture"
                      and lo <= s.start and s.end <= hi)
