"""Device-honest micro-benchmark harness (counterpart of the JAX package's
``utils/benchmark.py``).

The op runs in a chain whose iteration i + 1 takes a scalar from
iteration i's output (so no iteration can be skipped or overlapped with
the next), each trial on fresh input values, and the result is the
median per-iteration time net of a 1-iteration calibration run. As in
the JAX package the per-iteration time includes the feed that links the
iterations, ``x + 1e-12 * sum(y[..., :1])`` over the whole of x (two
small kernels on the card); a caller that wants the op alone subtracts
the same chain on the identity op. On the card the ``iters``-long and
the 1-long chains are captured as CUDA graphs and their replays timed
with CUDA events, so host launch costs drop out; on the CPU the same
loops run under ``time.perf_counter``.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def _chained_loop(op: Callable, x: torch.Tensor, args: tuple,
                  iters: int) -> torch.Tensor:
    """op(x, *args) -> y ``iters`` times, each time adding the sum of y's
    first column times 1e-12 to every element of x, so the iterations are
    sequentially dependent. Returns the last x."""
    for _ in range(iters):
        y = op(x, *args)
        x = torch.add(x, y[..., :1].sum().to(x.dtype), alpha=1e-12)
    return x


def _chain_timer(op: Callable, x: torch.Tensor, args: tuple, iters: int):
    """``run(n)``: seconds of the n-long chain (n in 1, ``iters``), after
    one run of each: captured graphs timed by CUDA events on the card,
    the host clock on the CPU."""
    if not x.is_cuda:
        def run(n):
            t0 = time.perf_counter()
            _chained_loop(op, x, args, n)
            return time.perf_counter() - t0
    else:
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):  # warm-up off the capture
            _chained_loop(op, x, args, 2)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graphs = {}
        for n in (1, iters):
            graphs[n] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[n]):
                _chained_loop(op, x, args, n)

        def run(n):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            graphs[n].replay()
            t1.record()
            t1.synchronize()
            return t0.elapsed_time(t1) / 1e3
    run(1)
    run(iters)
    return run


def bench_op(op: Callable, x0: torch.Tensor, *args, iters: int = 100,
             trials: int = 3) -> float:
    """Median per-iteration seconds of op(x, *args) on x0's device, the
    feed included (module docstring).

    Pass large operands (weights) through ``*args``: the chains reuse
    them as they are, while x is a buffer of the harness."""
    x = x0.clone(memory_format=torch.contiguous_format)
    run = _chain_timer(op, x, args, iters)
    results = []
    for t in range(trials):
        x.copy_(x0 * (1.0 + 1e-3 * (t + 1)))  # fresh values each trial
        t1 = run(1)
        x.mul_(1.0 + 1e-4)
        results.append(max((run(iters) - t1) / (iters - 1), 1e-9))
    return float(np.median(results))
