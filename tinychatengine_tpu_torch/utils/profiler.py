"""Per-turn throughput reporter (copy of the JAX package's Profiler) and
``device_trace``, a ``torch.profiler`` trace for deep dives.

Host wall-clock sections with FLOPs accounting; callers pass
device-synchronized boundaries (e.g. after fetching a token).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from pathlib import Path

import torch


@dataclasses.dataclass
class SectionStat:
    total_s: float = 0.0
    count: int = 0
    flops: float = 0.0


class Profiler:
    """Section timer with FLOPs accounting."""

    def __init__(self):
        self._sections: dict[str, SectionStat] = defaultdict(SectionStat)
        self.ttft_s: float | None = None

    @contextlib.contextmanager
    def section(self, name: str, flops: float = 0.0):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        s = self._sections[name]
        s.total_s += dt
        s.count += 1
        s.flops += flops

    def report(self) -> str:
        """Section, Total(us), Average(us), Count, GOPs."""
        lines = [f"{'Section':<28}{'Total(us)':>12}{'Avg(us)':>10}"
                 f"{'Count':>8}{'GOPs':>8}"]
        for name, s in sorted(self._sections.items()):
            gops = (s.flops / (s.total_s * 1e6) / 1e3) if s.total_s else 0.0
            lines.append(f"{name:<28}{s.total_s * 1e6:>12.0f}"
                         f"{s.total_s * 1e6 / max(s.count, 1):>10.0f}"
                         f"{s.count:>8}{gops:>8.1f}")
        return "\n".join(lines)

    def report_turn(self, n_tokens: int, section: str = "decode") -> str:
        """Demo-mode per-turn summary."""
        s = self._sections[section]
        if s.total_s == 0 or n_tokens == 0:
            return "Inference latency: n/a"
        ms_per_tok = s.total_s * 1e3 / n_tokens
        out = (f"Inference latency: total {s.total_s:.2f}s, "
               f"{ms_per_tok:.1f} ms/token, {1e3 / ms_per_tok:.1f} token/s, "
               f"{n_tokens} tokens")
        if self.ttft_s is not None:
            out += f", TTFT {self.ttft_s * 1e3:.0f} ms"
        return out

    def reset(self):
        self._sections.clear()
        self.ttft_s = None


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
