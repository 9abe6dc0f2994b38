"""``device_trace``, a ``torch.profiler`` trace for deep dives (the
always-on spans of the serving path are ``utils/tracing.py``'s)."""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """``torch.profiler`` over the block: CPU activity, and CUDA activity
    when ``device`` is a CUDA device (default: when a card is present).
    Writes the Chrome trace ``logdir/trace.json`` on exit (also when the
    block raises) and yields the profiler (``key_averages()``,
    ``events()``)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=acts)
    try:
        with prof:
            yield prof
            if cuda:
                torch.cuda.synchronize(device)
    finally:  # the trace is written also when the block raises
        prof.export_chrome_trace(str(out / "trace.json"))
