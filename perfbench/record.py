"""What one run measured, as the metric readers see it (``rec``).

Times are host seconds (``time.perf_counter``). ``calls`` are the
benchmark's spans around each call into the program made while the window
was open: a ``ServingEngine.step()`` (open loop) or an
``Engine.generate_device`` with its fetch (closed loop), each with what
the call did (ticks, admission, tokens) and the roofline bound of that
work (``work.Bound``). ``traced_calls`` are those of a traced run's
profiled slice, which follows the window. ``requests`` are the requests due in the window
(open loop) or the calls made in it (closed loop).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from perfbench.work import Bound


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    admit: bool = False        # an admission chunk or batch ran in it
    ticks: int = 0             # decode ticks (serving) or steps (generate)
    tokens: int = 0            # tokens emitted
    bound: Bound = dataclasses.field(default_factory=Bound)

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Req:
    n_prompt: int
    n_out: int                 # tokens asked for
    due: float                 # when it was due (open loop) or started
    submit: float = 0.0
    first: float = 0.0         # first token on the host (0: none)
    done: float = 0.0          # last token on the host (0: unfinished)
    emitted: int = 0


@dataclasses.dataclass
class Record:
    setup_s: float = 0.0
    t_open: float = 0.0
    t_close: float = 0.0
    tokens: int = 0            # tokens emitted inside the window
    calls: list = dataclasses.field(default_factory=list)
    traced_calls: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    deadline: float = 0.0      # the drain's end: unfinished requests fail
    trace: Optional[object] = None   # trace.Summary of the profiled slice
    profiled_s: float = 0.0          # the profiled slice's host seconds
    step_ms: Optional[float] = None  # closed loop: (t(n) - t(1)) / (n - 1)
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open
