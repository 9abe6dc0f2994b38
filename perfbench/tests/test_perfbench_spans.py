"""The readers of the port's spans (``perfbench/spans.py`` and their
``metrics/`` files) on spans built by hand, on a wrapped ring, on a port
without a tracer, and on traced tiny rehearsals."""

import collections
import sys
import time

import pytest

from perfbench import run, spans, spec
from perfbench.record import Record

S = collections.namedtuple("S", "name start end id parent request a b")
NEW = ["queue_wait_p95_ms.ttft", "admit_p95_ms.ttft", "pad_share.ttft",
       "dead_row_share.tpot", "host_share.tpot", "capture_s.setup"]
SEED = 2 ** 31 + 29


def _rec():
    """Set-up from 5 s, the window 10-20 s."""
    return Record(setup_s=5.0, t_open=10.0, t_close=20.0)


def _s(name, t0, t1, sid=0, parent=0, request=0, a=0, b=0):
    return S(name, round(t0 * 1e9), round(t1 * 1e9), sid, parent, request,
             a, b)


def test_admissions_are_cut_at_open_and_close():
    got = [_s("serve.admit.chunk", 9.9, 10.1, a=512, b=100),   # straddles
           _s("serve.admit.chunk", 11, 11.2, a=512, b=512),
           _s("serve.admit.batch", 12, 12.1, a=4 * 128, b=384),
           _s("serve.admit.chunk", 19.9, 20.1, a=64, b=1),     # straddles
           _s("serve.admit.chunk", 21, 21.1, a=64, b=1)]
    assert spans.pad_share(_rec(), got) == pytest.approx(
        100 * 128 / 1024)
    assert spans.pad_share(_rec(), got[:1] + got[3:]) is None


def test_dead_rows_count_the_engines_slots_each_tick():
    got = [_s("serve.engine", 1, 1, a=4),
           _s("serve.engine", 6, 6, a=64),          # the run's own
           _s("serve.decode", 9, 10.5, a=16, b=1),  # before the window
           _s("serve.decode", 11, 11.1, a=16, b=48),
           _s("serve.decode", 12, 12.1, a=1, b=64),
           _s("serve.engine", 25, 25, a=8),         # after it
           _s("serve.decode", 19.99, 20.01, a=1, b=0)]
    want = 100 * (16 * 16 + 0) / (64 * 17)
    assert spans.dead_row_share(_rec(), got) == pytest.approx(want)
    assert spans.dead_row_share(_rec(), got[2:5]) is None  # no engine


def test_the_window_requests_are_those_first_queued_in_it():
    got = [_s("req.queued", 8, 9, request=1),      # before the window,
           _s("req.admit", 9, 10.5, request=1),
           _s("req.queued", 12, 13, request=1),    # then requeued in it
           _s("req.admit", 13, 13.5, request=1),
           _s("req.queued", 11, 11.25, request=2),
           _s("req.admit", 11.25, 11.5, request=2),
           _s("req.queued", 15, 15.1, request=3),
           _s("req.admit", 15.1, 15.2, request=3),
           _s("req.queued", 16, 16.5, request=3),  # its second wait
           _s("req.admit", 16.5, 19, request=3),
           _s("req.queued", 19.5, 21, request=4),  # waits past the close
           _s("req.admit", 21, 22, request=4),
           _s("req.queued", 20.5, 21, request=5)]  # after the close
    ms = spans.phase_ms(_rec(), got, "req.queued", 50)
    assert ms == pytest.approx(250.0)   # 250, 100, 1500
    assert spans.phase_ms(_rec(), got, "req.queued", 100) == \
        pytest.approx(1500.0)
    assert spans.phase_ms(_rec(), got, "req.admit", 100) == \
        pytest.approx(1000.0)           # 250, 100, 1000
    assert spans.phase_ms(_rec(), got[:4], "req.queued", 95) is None


def test_host_share_reads_the_decode_only_steps():
    got = [_s("serve.step", 11, 11.1, sid=1),
           _s("serve.decode", 11.01, 11.09, sid=2, parent=1, a=16, b=3),
           _s("serve.sync", 11.02, 11.08, sid=3, parent=2),
           _s("serve.step", 12, 12.2, sid=4, a=1),            # admits
           _s("serve.admit.chunk", 12, 12.1, sid=5, parent=4),
           _s("serve.sync", 12.05, 12.1, sid=6, parent=5),
           _s("serve.decode", 12.1, 12.2, sid=7, parent=4, a=1, b=3),
           _s("serve.sync", 12.15, 12.19, sid=8, parent=7),
           _s("serve.step", 13, 13.1, sid=9, b=2),            # batches
           _s("serve.step", 14, 14.1, sid=10),
           _s("serve.decode", 14, 14.1, sid=11, parent=10, a=1, b=3),
           _s("serve.sync", 14.09, 14.1, sid=12, parent=11),
           _s("serve.step", 9.99, 10.1, sid=13),              # straddles
           _s("serve.sync", 10.0, 10.09, sid=14, parent=13)]
    assert [s.id for s in got if s.name == "serve.step"
            and spans.decode_only(s)] == [1, 10, 13]
    assert spans.host_share(_rec(), got) == pytest.approx(
        100 * (0.2 - 0.06 - 0.01) / 0.2)
    assert spans.host_share(_rec(), got[3:9]) is None


def test_capture_s_reads_the_set_up():
    got = [_s("graph.capture", 4, 4.5),    # before this run
           _s("graph.capture", 6, 6.25),
           _s("graph.capture", 9, 9.5),
           _s("graph.capture", 12, 12.5)]  # in the window
    assert spans.capture_s(_rec(), got) == pytest.approx(0.75)
    assert spans.capture_s(_rec(), []) == 0.0


def _readers():
    return {m: spec.reader(m) for m in NEW}


def test_a_wrapped_ring_reads_none(monkeypatch):
    from tinychatengine_tpu_torch.utils import tracing
    ring = tracing.Recorder(8)
    monkeypatch.setattr(tracing, "RECORDER", ring)
    t = time.perf_counter()
    rec = Record(setup_s=1.0, t_open=t, t_close=t + 1.0)
    for _ in range(8):
        ring.end(ring.begin(tracing.STEP))
    assert ring.dropped == 0 and len(spans.load(rec)) == 8
    ring.end(ring.begin(tracing.STEP))
    assert ring.dropped == 1 and spans.load(rec) is None
    for name, read in _readers().items():
        assert read(rec) is None, name
    for fn in (spans.pad_share, spans.dead_row_share, spans.host_share,
               spans.capture_s):
        assert fn(rec, None) is None


def test_a_port_without_a_tracer_reads_none(monkeypatch):
    """The parent of the change that added the tracer: its readers are
    silent and do not raise."""
    import tinychatengine_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "tinychatengine_tpu_torch.utils.tracing",
                        None)
    rec = Record(setup_s=1.0, t_open=1.0, t_close=2.0)
    for name, read in _readers().items():
        assert read(rec) is None, name


@pytest.mark.parametrize("cell", ["tiny_llama.chat",
                                  "tiny_starcoder.complete",
                                  "tiny_llama.solo"])
def test_a_traced_rehearsal_reads_every_new_metric(tiny, cell):
    repo, root = tiny
    bench = spec.benchmark(repo)
    result, _ = run.execute(bench, spec.workload(bench, cell), SEED, 1.5,
                            True, "cpu", time.perf_counter(), root=root)
    want = {m["name"] for m in spec.cell_metrics(bench, cell, True)} \
        & set(NEW)
    assert want == (set(NEW) if cell.endswith((".chat", ".complete"))
                    else {"capture_s.setup"})
    got = result["metrics"]
    assert want <= set(got), sorted(got)
    for name in want - {"capture_s.setup"}:
        assert got[name]["value"] > 0, (name, got[name])
    assert got["capture_s.setup"]["value"] == 0.0  # no graphs on the CPU
    assert got.get("pad_share.ttft", {"value": 0})["value"] < 100
