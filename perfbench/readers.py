"""What the metric readers (``metrics/<name>.py``) share. Each returns a
number, or None where the run has nothing to read (the metric is then
left out of the result line); shares are percentages.

Host-clock readers read the window's calls, which never run under the
profiler (a ``--trace 1`` run records its slice after the window); device
readers read the profiled slice and the calls made in it.
"""

from __future__ import annotations

from perfbench.traffic import percentile


def decode_only(c) -> bool:
    return c.ticks > 0 and not c.admit


def ttft_ms(rec, q: float):
    """q-th percentile of (first token - due) over the window's requests;
    one that never gave a token counts as given at the drain's end."""
    v = [((r.first or rec.deadline) - r.due) * 1e3 for r in rec.requests]
    return percentile(v, q) if v else None


def tpot_ms(rec, q: float):
    """q-th percentile of (done - first) / (n_out - 1) over the window's
    finished requests of two tokens or more."""
    v = [(r.done - r.first) * 1e3 / (r.n_out - 1) for r in rec.requests
         if r.done and r.first and r.n_out >= 2]
    return percentile(v, q) if v else None


def share_of_window(rec, keep) -> float:
    """Wall of the window's calls that ``keep`` selects, over the
    window's time, in %."""
    if not rec.calls or rec.window_s <= 0:
        return None
    return 100.0 * sum(c.wall for c in rec.calls if keep(c)) / rec.window_s


def ms_per_tick(rec, keep) -> float:
    calls = [c for c in rec.calls if keep(c)]
    ticks = sum(c.ticks for c in calls)
    return 1e3 * sum(c.wall for c in calls) / ticks if ticks else None


def mfu(rec, keep) -> float:
    """Roofline bound of all the work of the selected calls over their
    wall, in %."""
    calls = [c for c in rec.calls if keep(c)]
    wall = sum(c.wall for c in calls)
    return 100.0 * sum(c.bound.total for c in calls) / wall if wall else None


def roofline(rec, cls: str) -> float:
    """Bound of class ``cls``'s work in the profiled slice over the device
    time of the class's kernels there, in %; a class no call counted
    reads None."""
    t = rec.trace
    if t is None or not t.class_s.get(cls):
        return None
    bound = sum(c.bound[cls] for c in rec.traced_calls)
    return 100.0 * bound / t.class_s[cls] if bound else None


def idle_share(rec) -> float:
    t = rec.trace
    share = None if t is None else t.idle_share
    return None if share is None else 100.0 * share
