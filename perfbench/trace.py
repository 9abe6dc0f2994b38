"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a
slice that follows the window (open loop: ``profile_s`` seconds of the
traffic that goes on while the window's requests drain; closed loop: the
set's median call), each call into the program (``ServingEngine.step``,
``Engine.generate_device`` and its fetch) inside a ``record_function``
span named ``CALL``. No call of the window runs under the profiler.

``summarize`` reduces the trace to what the per-layer readers and the
result's ``device`` and ``breakdown`` need: the union of device intervals
(busy), its part inside the calls, each kernel class's device time (the
union of its kernels' intervals, so overlapping launches count once), the
device operations that took most time, and the longest idle gaps inside
the calls, each named by the innermost host operation running at its
middle.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

CALL = "perfbench.call"
TOP = 10            # entries of each breakdown list
GAPS_NAMED = 4000   # longest gaps attributed to a host operation
WARM_S = 0.5        # traffic under the started profiler before it records


@dataclasses.dataclass
class Summary:
    window_s: float                   # the traced slice's length
    busy_s: float                     # union of device intervals
    calls_s: float                    # union of the calls' spans
    calls_busy_s: float               # device busy inside the calls
    class_s: dict                     # kernel class -> device seconds
    device_ops: list                  # [[name, seconds]] most time first
    idle_gaps: list                   # [[host op, seconds]] longest first

    @property
    def idle_share(self) -> Optional[float]:
        if self.calls_s <= 0 or self.busy_s <= 0:
            return None
        return 1.0 - self.calls_busy_s / self.calls_s


class Profile:
    """``torch.profiler`` whose slow start (the tracer's set-up, seconds on
    the card) happens in ``prepare``; it then warms up, without keeping
    what it sees, until ``record`` starts the recording, and ``stop``
    ends it. ``events`` reads the recording's raw events once the run no
    longer serves."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts,
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1))

    def events(self) -> list:
        """(name, on the device, start us, end us) of every event. The
        raw events, not ``profile.events()``, whose tree of a second of
        serving takes tens of seconds to build."""
        from torch.autograd import DeviceType
        raw = self._prof.profiler.kineto_results.events()
        t0 = min((e.start_ns() for e in raw), default=0)  # exact integers
        return [(e.name(), e.device_type() == DeviceType.CUDA,
                 (e.start_ns() - t0) * 1e-3, (e.end_ns() - t0) * 1e-3)
                for e in raw]

    def prepare(self) -> None:
        self._prof.start()

    def record(self) -> None:
        self._prof.step()

    def stop(self) -> None:
        self._prof.step()
        self._prof.stop()


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    n = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.split(r"[<(]", n)[0][:80] or name[:80]


def union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged intervals of [n, 2] starts and ends."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, dtype=np.float64)


def length(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0


def intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        if lo < hi:
            out.append((lo, hi))
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def summarize(events, window_s: float, classes: dict) -> Summary:
    """The summary of a recording's events (``Profile.events``). The
    calls' spans appear on the device too, as annotations: they are no
    device work."""
    dev, host, calls = [], [], []
    for name, on_device, a, b in events:
        if on_device:
            if name != CALL:
                dev.append((name, a, b))
        elif name == CALL:
            calls.append((a, b))
        elif not name.startswith("ProfilerStep"):  # the recording itself
            host.append((name, a, b))
    us = 1e-6
    dev_iv = union(np.asarray([d[1:] for d in dev], np.float64))
    call_iv = union(np.asarray(calls, np.float64))
    busy_calls = intersect(dev_iv, call_iv)
    member = {(cls, n): any(p.search(n) for p in pats)
              for cls, pats in classes.items() for n in {d[0] for d in dev}}
    class_s = {}
    for cls in classes:
        mine = [d[1:] for d in dev if member[(cls, d[0])]]
        class_s[cls] = length(union(np.asarray(mine, np.float64))) * us
    by_name: dict[str, float] = {}
    for name, a, b in dev:
        k = short_name(name)
        by_name[k] = by_name.get(k, 0.0) + (b - a) * us
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(window_s=window_s, busy_s=length(dev_iv) * us,
                   calls_s=length(call_iv) * us,
                   calls_busy_s=length(busy_calls) * us, class_s=class_s,
                   device_ops=[[n, s] for n, s in ops],
                   idle_gaps=_idle_gaps(dev_iv, call_iv, host))


def _idle_gaps(dev_iv: np.ndarray, call_iv: np.ndarray, host: list) -> list:
    """Idle time inside the calls, summed by the innermost host operation
    running at each gap's middle ("(none)" where none ran)."""
    idle = []
    for a, b in call_iv:
        inside = dev_iv[(dev_iv[:, 1] > a) & (dev_iv[:, 0] < b)] \
            if len(dev_iv) else dev_iv
        t = a
        for s, e in inside:
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if t < b:
            idle.append((t, b))
    if not idle:
        return []
    idle = np.asarray(idle, np.float64)
    idle = idle[np.argsort(idle[:, 0] - idle[:, 1])][:GAPS_NAMED]
    names = [h[0] for h in host]
    hs = np.asarray([h[1] for h in host], np.float64)
    he = np.asarray([h[2] for h in host], np.float64)
    total: dict[str, float] = {}
    for a, b in idle:
        mid = 0.5 * (a + b)
        cover = np.nonzero((hs <= mid) & (he >= mid))[0] if len(hs) else []
        name = "(none)"
        if len(cover):
            name = names[cover[np.argmin(he[cover] - hs[cover])]]
        total[name] = total.get(name, 0.0) + (b - a) * 1e-6
    return [[n, s] for n, s in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
