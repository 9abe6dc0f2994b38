"""The port's always-on tracer (``utils/tracing.py``) on the CPU: the ring,
each request's phases, the serving spans' counts against ``tick_stats``,
``_bucket`` and the slot count, the ``tce.`` twins under ``torch.profiler``
(and none without it), the Engine's spans, and ``chat.py``'s per-turn
line."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation.engine import Engine, _bucket
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.runtime.serving import ServingEngine
from tinychatengine_tpu_torch.utils import tracing

TINY = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
            num_layers=2, max_sqlen=128, embed_dim=128, hidden_dim=256,
            vocab_size=256, rms_norm_eps=1e-5)
GREEDY = dict(temp=0.0, repeat_penalty=1.0, repeat_last_n=1)
SHORT = [np.array([5, 9, 11]), np.array([7, 3]), np.array([42]),
         np.array([1, 2, 3, 4]), np.arange(20, 37)]
LONG = np.arange(10, 74)  # four chunks of 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg, qcfg = ModelConfig(**TINY), QuantConfig(scheme="fp")
    return cfg, qcfg, llama.init_random_params(cfg, qcfg, seed=0,
                                               device="cpu")


def _srv(tiny, **kw):
    cfg, qcfg, params = tiny
    return ServingEngine(params, cfg, qcfg, device="cpu",
                         gcfg=GenerationConfig(n_predict=12, **GREEDY), **kw)


def _mixed_load(srv):
    """Short prompts at once (a batched admission, dense), then a long one
    that admits in chunks while the others decode, in bursts and single
    ticks."""
    reqs = [srv.submit(p, n_predict=6 + 3 * i) for i, p in enumerate(SHORT)]
    srv.step()
    reqs.append(srv.submit(LONG, n_predict=10))
    srv.run()
    return reqs


def _by_request(spans):
    out = {}
    for s in spans:
        if s.name.startswith("req."):
            out.setdefault(s.request, []).append(s)
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_request_phases_tile_each_life(tiny, paged):
    """Each request's queued and admit phases follow one another with no
    gap, from ``submit_t`` to ``first_token_t``, each under the step that
    ended it."""
    t0 = time.perf_counter_ns()
    srv = _srv(tiny, slots=4, admission_chunk=16, tick_batch=4, paged=paged,
               page_size=16)
    reqs = _mixed_load(srv)
    spans = tracing.snapshot(t0)
    steps = {s.id for s in spans if s.name == "serve.step"}
    phases = _by_request(spans)
    assert set(phases) == {r.trace_id for r in reqs}
    for r in reqs:
        q, a = phases[r.trace_id]
        assert [q.name, a.name] == ["req.queued", "req.admit"]
        assert q.start == tracing.ns(r.submit_t)
        assert q.end == a.start
        assert a.end == tracing.ns(r.first_token_t)
        assert {q.parent, a.parent} <= steps
        assert (q.a, q.b, a.a, a.b) == (0, 0, 0, 0)
    chunks = [s for s in spans if s.name == "serve.admit.chunk"
              and s.request == reqs[-1].trace_id]
    (a,) = [s for s in phases[reqs[-1].trace_id] if s.name == "req.admit"]
    assert len(chunks) == 4  # LONG's; the last one emits its first token
    assert a.start <= chunks[0].start
    assert chunks[-1].start <= a.end <= chunks[-1].end


def test_two_engines_keep_their_requests_apart(tiny):
    """Request ids count per engine; the spans' trace keys count per
    process, so two engines' requests never share one."""
    t0 = time.perf_counter_ns()
    one, two = _srv(tiny, slots=2), _srv(tiny, slots=2)
    reqs = [srv.submit(p, n_predict=3) for srv in (one, two)
            for p in SHORT[:2]]
    one.run()
    two.run()
    assert [r.request_id for r in reqs] == [0, 1, 0, 1]
    assert len({r.trace_id for r in reqs}) == 4
    phases = _by_request(tracing.snapshot(t0))
    for r in reqs:
        assert phases[r.trace_id][-1].end == tracing.ns(r.first_token_t)


def test_preempted_and_cancelled_requests_keep_their_phases(tiny):
    """A preempted request opens a new ``req.queued`` under its key where
    it was preempted, and is admitted again; a request cancelled while
    queued or admitted ends that phase at ``done_t``, one cancelled while
    it decodes records nothing more."""
    t0 = time.perf_counter_ns()
    tight = _srv(tiny, slots=2, paged=True, page_size=16, n_pages=4)
    got = [tight.submit(p, n_predict=20) for p in SHORT[:3]]
    tight.run()
    srv = _srv(tiny, slots=2, admission_chunk=16, tick_batch=1)
    ra = srv.submit(SHORT[0])
    rq = srv.submit(SHORT[2])
    srv.cancel(rq)
    srv.step()
    rb = srv.submit(LONG)
    srv.step()
    srv.cancel(rb)
    while len(ra.output_ids) < 4:
        srv.step()
    srv.cancel(ra)
    spans = tracing.snapshot(t0)
    t_tight = tracing.ns(max(r.done_t for r in got))
    by_tight = _by_request([s for s in spans if s.start <= t_tight])
    requeued = 0
    for r in got:
        chain = by_tight[r.trace_id]
        names = [s.name for s in chain]
        assert names == ["req.queued", "req.admit"] * (len(chain) // 2)
        for q, a in zip(chain[::2], chain[1::2]):
            assert q.end == a.start
        for a, q in zip(chain[1::2], chain[2::2]):  # decoded, preempted
            assert a.end < q.start <= tracing.ns(r.done_t)
        assert chain[-1].end == tracing.ns(r.first_token_t)
        requeued += names.count("req.queued") - 1
    assert requeued >= 1
    last = _by_request(spans)
    assert last[rq.trace_id][-1].name == "req.queued"
    assert last[rb.trace_id][-1].name == "req.admit"
    for r in (rq, rb):
        assert last[r.trace_id][-1].end == tracing.ns(r.done_t)
        assert last[r.trace_id][-1].parent == 0  # cancelled outside a step
    assert last[ra.trace_id][-1].end == tracing.ns(ra.first_token_t)


def test_step_spans_sum_to_tick_stats(tiny):
    """Over bursts, chunked admissions and a batched admission: the steps'
    counts equal ``tick_stats``; each admission's positions are its
    bucket's, the decode spans' live rows at most the slots, and each emit
    loop lies in the decode or admission it emits for."""
    t0 = time.perf_counter_ns()
    srv = _srv(tiny, slots=6, admission_chunk=16, tick_batch=4)
    reqs = _mixed_load(srv)
    spans = tracing.snapshot(t0)
    ts = srv.tick_stats
    assert ts["bursts"] and ts["single_ticks"] and ts["batch_admits"]
    steps = [s for s in spans if s.name == "serve.step"]
    assert sum(s.a for s in steps) == ts["admit_chunks"]
    assert sum(s.b for s in steps) == ts["batch_admit_reqs"]
    dec = [s for s in spans if s.name == "serve.decode"]
    assert sum(s.a for s in dec) == ts["burst_ticks"] + ts["single_ticks"]
    assert sum(s.a > 1 for s in dec) == ts["bursts"]
    (engine,) = [s for s in spans if s.name == "serve.engine"]
    assert engine.a == srv.n_slots
    assert all(0 < s.b <= srv.n_slots for s in dec)
    # each request's first token is its admission's, the rest its ticks'
    assert sum(len(r.output_ids) - 1 for r in reqs) <= sum(s.a * s.b
                                                           for s in dec)
    by_id = {s.id: s for s in spans}
    emits = [s for s in spans if s.name == "serve.emit"]
    singles = len(reqs) - ts["batch_admit_reqs"]
    assert len(emits) == len(dec) + ts["batch_admits"] + singles
    for s in emits:
        assert by_id[s.parent].name in ("serve.decode", "serve.admit.batch",
                                        "serve.admit.chunk")

    (batch,) = [s for s in spans if s.name == "serve.admit.batch"]
    lens = [len(p) for p in SHORT[:4]]  # the power-of-two queue head
    assert (batch.a, batch.b) == (4 * _bucket(max(lens)), sum(lens))
    chunks = [s for s in spans if s.name == "serve.admit.chunk"]
    for r in reqs:
        mine = [s for s in chunks if s.request == r.trace_id]
        assert sum(s.b for s in mine) in (0, len(r.prompt_ids))
        assert all(s.a == _bucket(s.b) for s in mine)
    assert len([s for s in chunks if s.request == reqs[-1].trace_id]) == 4
    assert len(chunks) == ts["admit_chunks"]


def test_sync_spans_lie_inside_the_steps(tiny):
    """Every token fetch waits inside a decode or an admission of a step."""
    t0 = time.perf_counter_ns()
    _mixed_load(_srv(tiny, slots=4, admission_chunk=16, tick_batch=4))
    spans = tracing.snapshot(t0)
    by_id = {s.id: s for s in spans}
    syncs = [s for s in spans if s.name == "serve.sync"]
    assert syncs
    for s in syncs:
        p = by_id[s.parent]
        assert p.name in ("serve.decode", "serve.admit.batch",
                          "serve.admit.chunk")
        assert p.start <= s.start <= s.end <= p.end
        assert by_id[p.parent].name == "serve.step"


def test_a_callback_that_cancels_a_later_slot_in_a_single_tick(tiny):
    """A token callback that cancels the request of a later slot in the
    same single tick: that slot is skipped, and its decode span still
    counts the rows live when the tick began."""
    t0 = time.perf_counter_ns()
    srv = _srv(tiny, slots=2, tick_batch=1)
    victim = []

    def on_token(tok, req):
        if len(req.output_ids) == 3:
            srv.cancel(victim[0])
    srv.submit(SHORT[0], n_predict=6, on_token=on_token)
    victim.append(srv.submit(SHORT[1], n_predict=6))
    srv.run()
    assert victim[0].finish_reason == "cancelled"
    assert len(victim[0].output_ids) == 2
    dec = [s for s in tracing.snapshot(t0) if s.name == "serve.decode"]
    assert [s.b for s in dec] == [2, 2, 1, 1, 1]


def test_a_tiny_ring_drops_the_oldest():
    r = tracing.Recorder(8)
    outer = r.begin(tracing.STEP)
    for i in range(18):
        h = r.begin(tracing.DECODE)
        r.end(h, i, 1)
    r.end(outer, 7)  # filed as it ends, after its 18 children
    assert r.dropped == 11
    got = r.snapshot()
    assert [s.a for s in got] == list(range(11, 18)) + [7]
    assert all(s.parent == outer and s.name == "serve.decode"
               for s in got[:-1])
    assert (got[-1].id, got[-1].name) == (outer, "serve.step")
    assert [s.a for s in r.snapshot(got[3].start, got[5].start)] == [14, 15]


def test_threads_keep_their_own_parents():
    """Spans begun on several threads at once (a short switch interval):
    every id once, each span's parent opened on its own thread, the
    newest span read back."""
    r = tracing.Recorder(1 << 14)
    n_threads, n = 6, 300

    def work(k):
        for _ in range(n):
            outer = r.begin(tracing.STEP, k)
            inner = r.begin(tracing.DECODE, k)
            r.record(tracing.REQ_QUEUED, 1, 2, inner, k)
            r.end(inner)
            r.end(outer)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = r.snapshot()
    assert len(got) == 3 * n_threads * n and r.dropped == 0
    assert sorted(s.id for s in got) == list(range(1, len(got) + 1))
    by_id = {s.id: s for s in got}
    for s in got:
        if s.parent:
            assert by_id[s.parent].request == s.request
    assert all(s.name == "serve.step" for s in got if not s.parent)


def test_spans_left_open_by_a_raise_close_with_their_parent():
    r = tracing.Recorder(16)
    outer = r.begin(tracing.STEP)
    r.begin(tracing.DECODE)  # never ended
    r.end(outer)
    after = r.begin(tracing.EMIT)
    r.end(after)
    names = {s.name: s for s in r.snapshot()}
    assert set(names) == {"serve.step", "serve.emit"}
    assert names["serve.emit"].parent == 0


def test_twins_under_the_profiler_nest_as_the_spans(tiny):
    """Under a CPU ``torch.profiler`` every span opened in it has a
    ``tce.<name>`` twin, a host operation (no user annotation, which the
    trace would also lay over the device), and each twin lies inside its
    parent span's twin."""
    srv = _srv(tiny, slots=4, admission_chunk=16, tick_batch=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter_ns()
        _mixed_load(srv)
        t1 = time.perf_counter_ns()
    spans = [s for s in tracing.snapshot(t0, t1)
             if not s.name.startswith("req.")]
    twins = {}
    kinds = {e.activity_type() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("tce.")}
    assert kinds == {"cpu_op"}
    for e in prof.events():
        if e.name.startswith("tce."):
            twins.setdefault(e.name[4:], []).append(
                (e.time_range.start, e.time_range.end))
    names = {s.name for s in spans}
    assert {"serve.step", "serve.decode", "serve.sync", "serve.emit",
            "serve.admit.batch", "serve.admit.chunk",
            "gen.prefill"} <= names
    twin_of = {}
    for name in names:
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.start)
        theirs = sorted(twins.get(name, []))
        assert len(theirs) == len(mine), name
        twin_of.update({s.id: t for s, t in zip(mine, theirs)})
    nested = 0
    for s in spans:
        if s.parent in twin_of:
            (a, b), (pa, pb) = twin_of[s.id], twin_of[s.parent]
            assert pa <= a and b <= pb, s
            nested += 1
    assert nested > len(spans) // 2


def _count_twins(monkeypatch):
    entered = [0]
    fast = tracing.TWIN

    class Counting:
        def __init__(self, name):
            self.rf = fast(name)

        def __enter__(self):
            entered[0] += 1
            return self.rf.__enter__()

        def __exit__(self, *exc):
            return self.rf.__exit__(*exc)
    monkeypatch.setattr(tracing, "TWIN", Counting)
    return entered


def test_no_twin_without_the_profiler(tiny, monkeypatch):
    entered = _count_twins(monkeypatch)
    t0 = time.perf_counter_ns()
    _mixed_load(_srv(tiny, slots=4, admission_chunk=16, tick_batch=4))
    assert len(tracing.snapshot(t0)) > 20
    assert entered[0] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        srv = _srv(tiny, slots=2)
        srv.submit(SHORT[0], n_predict=3)
        srv.run()
    assert entered[0] > 0


def test_engine_prefill_and_decode_spans(tiny):
    cfg, qcfg, params = tiny
    eng = Engine(params, cfg, qcfg, batch=1, max_len=cfg.max_sqlen,
                 device="cpu")
    t0 = time.perf_counter_ns()
    eng.generate_device(np.arange(3, 43)[None],
                        GenerationConfig(n_predict=5, **GREEDY))
    got = tracing.snapshot(t0)
    assert [s.name for s in got] == ["gen.prefill", "gen.decode"]
    assert got[0].end <= got[1].start


@pytest.mark.parametrize("n,decode_s,ttft_s", [
    (12, 0.4567, 0.0234), (1, 0.0011, 1.5), (0, 0.3, 0.1), (5, 0.0, 0.1)])
def test_chat_turn_line_reads_as_before(n, decode_s, ttft_s):
    """The per-turn line of the profiler it replaces (the JAX package's
    copy of it), text for text."""
    from tinychatengine_tpu.utils.profiler import Profiler
    from tinychatengine_tpu_torch.chat import turn_line
    p = Profiler()
    p._sections["decode"].total_s = decode_s
    p.ttft_s = ttft_s
    assert turn_line(n, decode_s, ttft_s) == p.report_turn(n)
