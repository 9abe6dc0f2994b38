"""The port's in-program tracer: one process-wide ring of spans at the
layer boundaries of the serving path, the graph captures and the Engine's
prefill and decode launches.

A span is a ``Span``: its name, start and end in ns of
``time.perf_counter_ns()`` (the clock of ``time.perf_counter()``), its id,
the id of the innermost span open on the same thread when it began (its
parent; 0 for none), a request's trace key (``Request.trace_id``, unique
in the process), and two integer counts ``a`` and ``b`` whose meaning its
name gives:

=====================  ==================================  ==============
name                   where                               a, b
=====================  ==================================  ==============
``serve.engine``       a ``ServingEngine`` made (instant)  slots, expert
                                                           weight sets
                                                           (layers x
                                                           experts; 0
                                                           without)
``serve.step``         ``ServingEngine.step()``            chunks run,
                                                           requests
                                                           batch-admitted
``serve.admit.batch``  one batched admission               positions
                                                           computed (rows
                                                           x bucket),
                                                           true positions
``serve.admit.chunk``  one admission chunk (the last with  positions
                       the splice and first token)         computed, true
                                                           positions
``serve.decode``       a burst, a single or a speculative  ticks, live
                       tick                                rows
``serve.sync``         a host wait on a token fetch        --
``serve.experts``      after a token fetch (instant): the  (layer, expert)
                       one-token forwards (decode ticks)   weight sets
                       since the last fetch                read, routed
                                                           (row, expert)
                                                           pairs
``serve.experts.       the same, of the longer forwards    as above
prefill``              (admissions, verify)
``serve.emit``         the emit loop of one decode or      --
                       admission
``req.queued``         submit (or requeue) to slot taken   --
``req.admit``          slot taken to first token           --
``graph.capture``      ``Graphs.capture``                  --
``gen.prefill``        ``Engine``'s prefill chunks         --
``gen.decode``         ``Engine.generate_device``'s        --
                       decode loop (launches only)
=====================  ==================================  ==============

A request's phases (``req.*``) are recorded when they end, from the
timestamps the scheduler keeps, under the step span in flight then.
The expert counts (``models/moe.py``) are kept on the device, added
inside captured graphs, and copied with the token fetch the scheduler
makes anyway; they are filed under the span open then.

Recording is always on: a span is a tuple appended to a bounded deque
(``CAPACITY`` spans; ``dropped`` counts what it pushed out). While
``torch.profiler`` records, each ``begin`` / ``end`` span also opens a
twin, a record function named ``tce.<name>``, so the program's spans lie
on the device trace's clock and name the host's idle gaps there (a
request phase, recorded after the fact, has none). The twin is ``TWIN``,
torch's fast record function, which the trace keeps as a host operation:
``torch.profiler.record_function``'s user annotation would also be laid
over the device's timeline as a span of its kernels, and read there as
device time.

    h = tracing.begin(tracing.STEP)
    ...
    tracing.end(h, a, b)
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

NAMES = ("serve.engine", "serve.step", "serve.admit.batch",
         "serve.admit.chunk", "serve.decode", "serve.sync", "serve.emit",
         "req.queued", "req.admit", "graph.capture", "gen.prefill",
         "gen.decode", "serve.experts", "serve.experts.prefill")
(ENGINE, STEP, ADMIT_BATCH, ADMIT_CHUNK, DECODE, SYNC, EMIT, REQ_QUEUED,
 REQ_ADMIT, CAPTURE, GEN_PREFILL, GEN_DECODE, EXPERTS,
 EXPERTS_PREFILL) = range(len(NAMES))
TWINS = tuple("tce." + n for n in NAMES)
TWIN = torch._C._profiler._RecordFunctionFast

CAPACITY = 1 << 18
REQUESTS = itertools.count(1)  # trace keys of requests, across engines


class Span(NamedTuple):
    name: str
    start: int
    end: int
    id: int
    parent: int
    request: int
    a: int
    b: int


def ns(t: float) -> int:
    """A ``time.perf_counter()`` reading in the spans' ns."""
    return round(t * 1e9)


class _Stack(threading.local):
    def __init__(self):
        # the spans open on this thread, innermost last:
        # (id, name, parent, request, start, twin or None)
        self.open = []


class Recorder:
    """The newest ``capacity`` spans, as tuples in the order they ended."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)  # next() is atomic across threads
        self._stack = _Stack()
        self.filed = 0

    @property
    def dropped(self) -> int:
        """Spans the ring pushed out."""
        return self.filed - len(self._ring)

    def begin(self, name: int, request: int = 0) -> int:
        """Open a span; returns its id, for ``end``."""
        sid = next(self._ids)
        stack = self._stack.open
        twin = None
        if torch._C._autograd._profiler_enabled():
            twin = TWIN(TWINS[name])
            twin.__enter__()
        stack.append((sid, name, stack[-1][0] if stack else 0, request,
                      time.perf_counter_ns(), twin))
        return sid

    def end(self, sid: int, a: int = 0, b: int = 0) -> None:
        """Close span ``sid``; spans left open inside it by a raise close
        unrecorded."""
        t = time.perf_counter_ns()
        stack = self._stack.open
        while stack:
            top, name, parent, request, start, twin = stack.pop()
            if twin is not None:
                twin.__exit__(None, None, None)
            if top == sid:
                self._ring.append((name, start, t, sid, parent, request, a,
                                   b))
                self.filed += 1
                return

    def current(self) -> int:
        """The id of the innermost span open on this thread (0: none)."""
        stack = self._stack.open
        return stack[-1][0] if stack else 0

    def record(self, name: int, start: int, end: int, parent: int = 0,
               request: int = 0, a: int = 0, b: int = 0) -> None:
        """Add a closed span whose ends (ns) the caller holds."""
        self._ring.append((name, start, end, next(self._ids), parent,
                           request, a, b))
        self.filed += 1

    def snapshot(self, t0: int = 0, t1: Optional[int] = None) -> list:
        """The spans that began in [t0, t1) (ns), in the order they
        ended."""
        return [Span(NAMES[s[0]], *s[1:]) for s in list(self._ring)
                if s[1] >= t0 and (t1 is None or s[1] < t1)]


RECORDER = Recorder()
begin, end, record = RECORDER.begin, RECORDER.end, RECORDER.record
snapshot = RECORDER.snapshot
