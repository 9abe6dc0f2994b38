"""Captured CUDA graphs for the port's device loops (counterpart of the JAX
package's compiled programs: ``jax.jit`` of one prompt bucket, and the
``lax.scan`` of ``generate_device`` and of the serving burst).

A ``Step`` is one step of such a loop: static buffers (its ``state``) and a
body that reads and writes only them, in place. Its first run
(``Graphs.run``) runs the body eagerly on a side stream (the real step,
which also warms up every library the body touches off the capture), then
captures the body into a CUDA graph; every later run replays the graph on
the current stream, with no host launch in the loop. A capture that fails
raises: nothing falls back to the eager loop. The garbage collector is off
while a body is captured: a graph it freed then (an engine dropped in a
reference cycle) would end the capture.

``Graphs`` holds an engine's steps, keyed by what their buffers captured
(cache storage, batch, bucket, ``ctx_cap``, the sampler's static fields,
the int4 routes), with one memory pool and one side stream. The Engine
and the server each keep one cache for their graphs, so the keys stay
few and a step holds no cache but that one. A body keeps nothing alive
in the pool: its results are copied into buffers made outside the
capture, so the pool holds temporaries only and the graphs may replay in
any order on one stream. ``captures`` counts the captures; each is a
``graph.capture`` span of ``utils/tracing.py``, over the eager first
step's launches, the capture and the graph's instantiation.

Kernel launches: a wrapper counts its launch when Python calls it, which a
replay skips. So the capture records what the body added to every counter
of ``ops._build`` (``record_launches``), takes it back (the capture ran
nothing) and adds it again at each replay.
"""

from __future__ import annotations

import collections
import gc
from typing import Callable

import torch

from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops import int4_matmul as int4m
from tinychatengine_tpu_torch.utils import tracing


def routes() -> tuple:
    """The module switches a captured forward bakes in (the fused decode,
    the K-outer table): part of every key, so a change captures anew."""
    return int4m.FUSED_DECODE, tuple(sorted(int4m.DECODE_KOUTER.items()))


def storage_key(*tensors) -> tuple:
    """(address, shape, dtype) of each tensor a graph reads or writes in
    place (a cache's buffers)."""
    return tuple((t.data_ptr(), tuple(t.shape), str(t.dtype))
                 for t in tensors if t is not None)


class Step:
    """One captured step: ``state`` (the static buffers, anything the body
    closes over) and ``body`` over it; ``generators`` are the
    ``torch.Generator``s the body draws from, registered with the graph so
    each replay draws as the eager step would."""

    def __init__(self, body: Callable[[], None], state, generators=()):
        self.body = body
        self.state = state
        self.generators = tuple(generators)
        self.graph = None
        self.launches = None

    def replay(self) -> None:
        self.graph.replay()
        self.launches.add()


class Graphs:
    """An engine's captured steps on ``device``: one memory pool, one side
    stream for the warm-up and the capture, at most ``MAX_STEPS`` steps
    (the least recently used one is dropped, and with it its graph and
    its buffers)."""

    MAX_STEPS = 16

    def __init__(self, device):
        self.device = torch.device(device)
        self.captures = 0
        self.steps: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self._stream = None

    def clear(self) -> None:
        """Drop every step, and with the last graph the memory pool: a
        capture into a pool whose graphs were all freed trips the caching
        allocator (``use_count > 0``), so the next capture opens a new
        one."""
        self.steps.clear()
        self._pool = None

    def step(self, key, build: Callable[[], Step]) -> Step:
        """The step under ``key``, made by ``build()`` on first use (not yet
        captured: its first run captures)."""
        st = self.steps.get(key)
        if st is None:
            st = build()
            self.steps[key] = st
            while len(self.steps) > self.MAX_STEPS:
                self.steps.popitem(last=False)
        else:
            self.steps.move_to_end(key)
        return st

    def run(self, step: Step) -> None:
        """One step: the replay of its graph, or on its first run the eager
        step and the capture."""
        if step.graph is None:
            self.capture(step)
        else:
            step.replay()

    def capture(self, step: Step) -> None:
        """Run ``step``'s body once eagerly on the side stream, then capture
        it (``record_launches`` keeps the counters to the eager run)."""
        span = tracing.begin(tracing.CAPTURE)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        side = self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            step.body()
            graph = torch.cuda.CUDAGraph()
            for gen in step.generators:
                graph.register_generator_state(gen)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with _build.record_launches() as launches:
                    graph.capture_begin(pool=self._pool)
                    try:
                        step.body()
                    except BaseException:
                        try:  # end the broken capture; its error stands
                            graph.capture_end()
                        except RuntimeError:
                            pass
                        raise
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        cur.wait_stream(side)
        step.graph, step.launches = graph, launches
        self.captures += 1
        tracing.end(span)
