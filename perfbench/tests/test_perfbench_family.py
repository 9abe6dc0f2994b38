"""A model family, and a kernel class with it, added to a copy of the
benchmark by new files and ``BENCHMARK.json`` entries alone (what a later
configuration of a new architecture brings): ``families/<family>.py``,
``reference/<family>.py``, ``configs/<config>.json``, a limits file and
a cell; for the class ``kernel_classes/<class>.json`` and
``metrics/<class>_roofline.py``. Every file taken from ``perfbench/``
stays byte-identical, and the new cell runs ``correct`` on the CPU."""

import json
import shutil
import time
from pathlib import Path

import pytest

from perfbench import drivers, run, spec, trace
from perfbench.model import model_from_config
from perfbench.tests.conftest import BENCH_DIR

SEED = 2 ** 31 + 47

# a family that is llama's under another name, delegating to the copy's
# own families/llama.py and reference/llama.py
FAMILY = '''"""llama's family under another name."""
from pathlib import Path

from perfbench import spec

_llama = spec.family("llama", Path(__file__).resolve().parent.parent)
sizes = _llama.sizes
port_config, port_quant = _llama.port_config, _llama.port_quant
build_params, fill, forward = _llama.build_params, _llama.fill, _llama.forward
decode_call, prefill_call = _llama.decode_call, _llama.prefill_call
'''
# the same, with its FFN linears' work under a kernel class of its own
FAMILY_WITH_CLASS = FAMILY.replace(
    "decode_call, prefill_call = _llama.decode_call, _llama.prefill_call\n",
    '''from perfbench import work

FFN = ("wgate_up", "down")


def _split(m, b, rows, call_rows, peaks):
    a8 = m.scheme == "w4a8" and call_rows <= work.A8_MAX_ROWS
    ffn = m.layers * sum(work._linear_bound(m, k, n, rows, peaks, a8)
                         for name, k, n, _ in m.linears() if name in FFN)
    b["linear"] -= ffn
    b["tiny_ffn"] = ffn
    return b


def decode_call(m, kv_lens, peaks, call_rows):
    b = _llama.decode_call(m, kv_lens, peaks, call_rows)
    return _split(m, b, len(kv_lens), call_rows, peaks)


def prefill_call(m, chunks, head_rows, peaks, call_rows):
    b = _llama.prefill_call(m, chunks, head_rows, peaks, call_rows)
    return _split(m, b, sum(t for _, t in chunks), call_rows, peaks)
''')
REFERENCE = '''"""llama's plain reference under another name."""
from pathlib import Path

from perfbench import spec

ROOT = Path(__file__).resolve().parent.parent
logits = spec.reference("llama", ROOT).logits
'''
CLASS = {"about": "the FFN linears' kernels",
         "patterns": [r"\bglu_act_kernel\b",
                      r"\(anonymous namespace\)::mlp_kernel\b"]}
READER = '''"""Bound of the FFN work in the profiled slice over the device time of
its kernels (kernel_classes/tiny_ffn*), in %."""

from perfbench import readers


def read(rec):
    return readers.roofline(rec, "tiny_ffn")
'''
CELLS = {"tiny_family": "tiny_family.chat",
         "tiny_family_k": "tiny_family_k.chat"}


def _write(path: Path, text: str) -> None:
    assert not path.exists(), path
    path.write_text(text)


@pytest.fixture(scope="module")
def extended(tiny, tmp_path_factory):
    """(repo root, perfbench dir) of a copy of ``tiny`` with the two
    families, the class and two cells added as new files and entries."""
    repo = tmp_path_factory.mktemp("family") / "repo"
    shutil.copytree(tiny[0], repo)
    root = repo / "perfbench"
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    base = json.loads((root / "configs" / "tiny_llama.json").read_text())
    for fam, cell in CELLS.items():
        _write(root / "families" / f"{fam}.py",
               FAMILY_WITH_CLASS if fam.endswith("_k") else FAMILY)
        _write(root / "reference" / f"{fam}.py", REFERENCE)
        _write(root / "configs" / f"{fam}.json",
               json.dumps(dict(base, family=fam)) + "\n")
        shutil.copyfile(root / "limits" / "tiny_llama.chat.json",
                        root / "limits" / f"{cell}.json")
        bench["configs"].append({
            "name": fam, "source": base["source"],
            "file": f"perfbench/configs/{fam}.json", "reduced": [],
            "why": "a family added by files alone"})
        bench["workloads"].append({
            "name": cell, "config": fam, "traffic": "tiny_tiny_llama.chat",
            "chips": 1, "why": "CPU stand-in: a family added by files"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "tiny_llama.chat" in m.get("workloads", []):
                m["workloads"].append(cell)
    _write(root / "kernel_classes" / "tiny_ffn.json",
           json.dumps(CLASS) + "\n")
    _write(root / "metrics" / "tiny_ffn_roofline.py", READER)
    bench["per_layer"].append({
        "name": "tiny_ffn_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels (ops/*.py wrappers, "
        "csrc/*.cu)", "moves": "tpot_p95_ms",
        "workloads": [CELLS["tiny_family_k"]]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench, indent=1) + "\n")
    return repo, root


def test_the_copy_keeps_every_file_of_the_benchmark(extended):
    _, root = extended
    taken = [p.relative_to(BENCH_DIR) for p in BENCH_DIR.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts
             and p.relative_to(BENCH_DIR).parts[0] != "tests"]
    assert taken
    for rel in taken:
        assert (root / rel).read_bytes() == (BENCH_DIR / rel).read_bytes(), \
            rel
    for fam in CELLS:
        assert not (BENCH_DIR / "families" / f"{fam}.py").exists()


@pytest.mark.parametrize("family", sorted(CELLS))
def test_a_family_added_by_files_alone_runs_correct(extended, family):
    repo, root = extended
    m = model_from_config(family, spec.config(family, root), root)
    assert m.family == family and type(m).__name__ == "Llama"
    bench = spec.benchmark(repo)
    cell = spec.workload(bench, CELLS[family])
    trace_run = family.endswith("_k")
    result, checks = run.execute(bench, cell, SEED, 1.5, trace_run, "cpu",
                                 time.perf_counter(), root=root)
    assert result["correct"] is True, checks
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {x["name"] for x in spec.cell_metrics(bench, cell["name"],
                                                 trace_run)}
    assert set(result["metrics"]) <= want
    if trace_run:
        # the CPU runs no kernel of the class: nothing to read, left out
        assert "tiny_ffn_roofline" in want
        assert "tiny_ffn_roofline" not in result["metrics"]


def test_a_new_kernel_class_finds_its_bound(extended):
    """The family's calls count the class's work, the class's file is
    found, and its roofline reader reads that work over the class's
    device time (planted: the CPU runs no kernel)."""
    repo, root = extended
    fam = "tiny_family_k"
    m = model_from_config(fam, spec.config(fam, root), root)
    assert "tiny_ffn" in spec.kernel_classes(root)
    mix = spec.traffic("tiny_tiny_llama.chat", root)
    drv = drivers.KINDS[mix["kind"]](m, mix, SEED, "cpu", spec.peaks(root))
    drv.setup()
    rec = drv.run(1.0, True, profile_s=0.5)
    drv.finish()
    drv.free()
    calls = rec.traced_calls
    ffn = sum(c.bound["tiny_ffn"] for c in calls)
    assert ffn > 0 and all(c.bound["tiny_ffn"] < c.bound.total
                           for c in calls if c.bound)
    rec.trace = trace.Summary(window_s=1.0, busy_s=1.0, calls_s=1.0,
                              calls_busy_s=1.0,
                              class_s={"tiny_ffn": 2 * ffn, "linear": 1.0},
                              device_ops=[], idle_gaps=[])
    assert spec.reader("tiny_ffn_roofline", root)(rec) == \
        pytest.approx(50.0)
    linear = sum(c.bound.linear for c in calls)
    assert spec.reader("linear_roofline", root)(rec) == \
        pytest.approx(100.0 * linear)
