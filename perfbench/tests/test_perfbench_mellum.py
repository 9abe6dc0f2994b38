"""The Mellum family and its cell, rehearsed on the CPU at a tiny size in
a copy of the benchmark (``conftest.tiny``) extended by new files and
entries alone: the cell runs ``correct``, its per-layer metrics read the
port's expert spans, and ``expert_roofline`` counts the expert bound from
those spans (planted device time: the CPU runs no kernel)."""

import json
import math
import shutil
import time

import pytest

from perfbench import drivers, run, spec, trace
from perfbench.model import model_from_config

SEED = 2 ** 31 + 83
CELL = "tiny_mellum.assist"


def _tiny_config(real: dict) -> dict:
    c = dict(real)
    kinds = ["sliding_attention"] * 3 + ["full_attention"]
    c.update(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
             head_dim=64, num_hidden_layers=4, layer_types=kinds,
             mlp_layer_types=["sparse"] * 4, sliding_window=32,
             num_experts=8, num_experts_per_tok=2, moe_intermediate_size=128,
             vocab_size=512, max_position_embeddings=1024,
             intermediate_size=512)
    full = dict(c["rope_parameters"]["full_attention"], factor=4,
                original_max_position_embeddings=64,
                attention_factor=1 + 0.1 * math.log(4))
    c["rope_parameters"] = {"full_attention": full,
                            "sliding_attention": {"rope_type": "default",
                                                  "rope_theta": 500000}}
    c["assumed"] = dict(c["assumed"], weight_std=0.03, router_std=0.1)
    return c


@pytest.fixture(scope="module")
def mellum(tiny, tmp_path_factory):
    """(repo root, perfbench dir) of a copy of ``tiny`` with a tiny Mellum
    configuration, a tiny assist mix, its limits and its cell."""
    repo = tmp_path_factory.mktemp("mellum") / "repo"
    shutil.copytree(tiny[0], repo)
    root = repo / "perfbench"
    real = json.loads((root / "configs" /
                       "mellum2_12b_a2.5b-w4a16.json").read_text())
    (root / "configs" / "tiny_mellum.json").write_text(
        json.dumps(_tiny_config(real)))
    t = json.loads((root / "traffic" / "assist.json").read_text())
    t["server"].update(max_len=512, slots=4, admission_chunk=64,
                       tick_batch=4)
    t.update(rate_rps=6.0, preroll_s=0.3, drain_limit_s=30, profile_s=0.5)
    t["prompt"].update(median=40, min=8, max=200)
    t["output"].update(median=16, min=4, max=40)
    t["check"]["tokens"] = 60
    (root / "traffic" / "tiny_assist.json").write_text(json.dumps(t))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"compare": {"gap": {"limit": 0.05}, "lower_launches": {"limit": 0}},
         "lower_kernels": ["_a8$", "_int8$", "^int8_decode$", "^int3_"],
         "compared_tokens_min": 10}))
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny_mellum",
                               "traffic": "tiny_assist", "chips": 1,
                               "why": "CPU stand-in for the assist cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mellum2_12b_a2.5b-w4a16.assist" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (repo / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return repo, root


@pytest.mark.parametrize("traced", [False, True])
def test_mellum_cell_runs_correct(mellum, traced):
    repo, root = mellum
    bench = spec.benchmark(repo)
    result, checks = run.execute(bench, spec.workload(bench, CELL), SEED,
                                 2.0, traced, "cpu", time.perf_counter(),
                                 root=root)
    assert result["correct"] is True, checks
    assert result["attempted"] > 0 and result["failed"] == 0
    if traced:
        # a program counter: read on the CPU too; the roofline needs the
        # device's kernels
        share = result["metrics"]["expert_read_share.tpot"]["value"]
        assert 0 < share <= 100
        assert "expert_roofline.tpot" not in result["metrics"]
    else:
        want = {m["name"] for m in spec.cell_metrics(bench, CELL, False)}
        assert set(result["metrics"]) == want \
            and {"tpot_p95_ms", "output_tok_s", "setup_s"} <= want


def test_expert_roofline_reads_the_counted_experts(mellum):
    """The reader's bound is ``expert_bound`` of the expert spans filed in
    the traced calls, over the class's device time."""
    _, root = mellum
    m = model_from_config("tiny_mellum", spec.config("tiny_mellum", root),
                          root)
    fam = spec.family("mellum", root)
    assert fam.expert_sets(m) == 4 * 8
    assert "expert" in spec.kernel_classes(root)
    mix = spec.traffic("tiny_assist", root)
    drv = drivers.KINDS[mix["kind"]](m, mix, SEED, "cpu", spec.peaks(root))
    drv.setup()
    rec = drv.run(1.0, True, profile_s=0.5)
    drv.finish()
    drv.free()
    from tinychatengine_tpu_torch.utils import tracing
    lo = round(rec.traced_calls[0].t0 * 1e9)
    hi = round(rec.traced_calls[-1].t1 * 1e9)
    spans = [s for s in tracing.snapshot(lo, hi + 1)
             if s.name in ("serve.experts", "serve.experts.prefill")
             and any(round(c.t0 * 1e9) <= s.start <= round(c.t1 * 1e9)
                     for c in rec.traced_calls)]
    assert spans
    bound = sum(fam.expert_bound(m, s.a, s.b, spec.peaks(root))
                for s in spans)
    rec.setup_s = 1.0
    rec.trace = trace.Summary(window_s=1.0, busy_s=1.0, calls_s=1.0,
                              calls_busy_s=1.0, class_s={"expert": 4 * bound},
                              device_ops=[], idle_gaps=[])
    assert spec.reader("expert_roofline.tpot", root)(rec) == \
        pytest.approx(25.0)
    # the family's own count of the calls: the expected experts of uniform
    # routing over the real rows, under the class's key
    assert all(c.bound["expert"] > 0 for c in rec.traced_calls if c.ticks)
