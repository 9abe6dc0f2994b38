"""Tiny end-to-end rehearsals of each cell on the CPU (the harness's look
for a card skipped), through the copy that ``conftest.tiny`` extends with
new files and entries alone, and the faults that must turn ``correct``
false."""

import json
import time

import numpy as np
import pytest
import torch

from perfbench import run, spec
from perfbench.tests.conftest import TINY_CELLS

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
SEED = 2 ** 31 + 11


def _execute(tiny, cell, trace=False, seconds=1.5, seed=SEED):
    repo, root = tiny
    bench = spec.benchmark(repo)
    t0 = time.perf_counter()
    return run.execute(bench, spec.workload(bench, cell), seed, seconds,
                       trace, "cpu", t0, root=root)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_prints_the_contract_line(tiny, cell, trace):
    result, checks = _execute(tiny, cell, trace)
    keys = set(result)
    assert keys - {"breakdown"} == KEYS and (trace or "breakdown" not in keys)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(checks) == {"gap", "lower_launches", "failed",
                           "compared_tokens"}
    for c in checks.values():
        assert set(c) == {"value", "limit"}
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = spec.benchmark(tiny[0])
    want = {m["name"] for m in spec.cell_metrics(bench, cell, trace)}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        # a CPU run reads no device metric; host-clock ones where the
        # window outlasts the profiled slice
        assert set(result["metrics"]) <= want
    else:
        assert set(result["metrics"]) == want
        for name, m in result["metrics"].items():
            assert m["value"] > 0 and m["unit"]
    json.dumps(result)


def _patch_forward(monkeypatch, family, wrap):
    from tinychatengine_tpu_torch.models import gptbigcode, llama
    mod = llama if family == "llama" else gptbigcode
    monkeypatch.setattr(mod, "forward", wrap(mod.forward))


def _family(cell):
    return "llama" if cell.startswith("tiny_llama") else "gptbigcode"


def fault_state_unchanged(monkeypatch, cell):
    """Decode steps leave the KV cache as it was."""
    from tinychatengine_tpu_torch.generation import kv_cache
    from tinychatengine_tpu_torch.runtime import paged
    upd = kv_cache.update_layer

    def frozen(cache, k, v, *a, **kw):
        if k.shape[1] != 1:
            return upd(cache, k, v, *a, **kw)
    monkeypatch.setattr(kv_cache, "update_layer", frozen)
    monkeypatch.setattr(paged, "paged_update_layer", lambda *a, **kw: None)


def fault_half_batch(monkeypatch, cell):
    """A decode forward computes half its rows (the even ones, where the
    server fills its slots first); each odd row takes its neighbour's."""
    def wrap(fwd):
        def half(params, cfg, ids, cache, start, *a, **kw):
            logits, cache = fwd(params, cfg, ids, cache, start, *a, **kw)
            b = logits.shape[0]
            if ids.shape[1] == 1 and b >= 2:
                logits = logits.clone()
                logits[1::2] = logits[0:b - b % 2:2]
            return logits, cache
        return half
    _patch_forward(monkeypatch, _family(cell), wrap)


def fault_token_altered(monkeypatch, cell):
    """Every sampled token is the next id."""
    from tinychatengine_tpu_torch.generation import sampling
    rows, one = sampling.sample_rows, sampling.sample

    def next_rows(logits, *a, **kw):
        tok, keys, mu = rows(logits, *a, **kw)
        return (tok + 1) % logits.shape[-1], keys, mu

    def next_one(logits, *a, **kw):
        tok, state = one(logits, *a, **kw)
        return (tok + 1) % logits.shape[-1], state
    monkeypatch.setattr(sampling, "sample_rows", next_rows)
    monkeypatch.setattr(sampling, "sample", next_one)


FAULTS = {"state_unchanged": fault_state_unchanged,
          "half_batch": fault_half_batch,
          "token_altered": fault_token_altered}


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    """At the cell's own load and check settings. The exchange between
    chips has no fault to plant: every cell runs on one chip. A batch of
    one has no half to leave out."""
    if fault == "half_batch" and cell.endswith(".solo"):
        pytest.skip("the closed loop runs a batch of one")
    FAULTS[fault](monkeypatch, cell)
    result, checks = _execute(tiny, cell)
    assert result["correct"] is False, checks
    assert any(c["value"] > c["limit"] for c in checks.values())
    assert checks["compared_tokens"]["value"] \
        >= checks["compared_tokens"]["limit"]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("kernel", ["flash_decode_int8", "int4_matmul_a8"])
def test_a_kernel_below_the_stated_precision_is_not_correct(
        tiny, monkeypatch, cell, kernel):
    """A run whose program launched a kernel below the configuration's
    precision (int8 KV in every cell, W4A8 in the W4A16 one) is not
    correct; the W4A8 cells' own int8 kernel is their precision. The CPU
    runs no kernel, so the launches are planted in the counter."""
    from perfbench import program
    counts = program.launches
    monkeypatch.setattr(program, "launches",
                        lambda: dict(counts(), **{kernel: 3}))
    result, checks = _execute(tiny, cell)
    lower = kernel == "flash_decode_int8" or "starcoder" in cell
    assert checks["lower_launches"]["value"] == (3 if lower else 0)
    assert result["correct"] is (not lower), checks


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_reads_above_the_program(tiny, cell):
    """The control that lowers every precision of the real cell's limits
    file by one step reads a wider mean gap than the program does at the
    tiny cell's size."""
    from perfbench import compare, drivers
    from perfbench.model import model_from_config
    repo, root = tiny
    cfg, _, real, _ = TINY_CELLS[cell]
    mix = spec.traffic(f"tiny_{cell}", root)
    model = model_from_config(cfg, spec.config(cfg, root))
    drv = drivers.KINDS[mix["kind"]](model, mix, SEED, "cpu",
                                     spec.peaks(root))
    drv.setup()
    drv.run(3.0, False)
    drv.finish()
    samples = drv.sample(dict(mix["check"], tokens=300))
    steps = spec.limits(real, root)["controls"]["all_lowered"]
    read = compare.readings(model, samples, SEED, "cpu", {"all": steps})
    lim = spec.limits(cell, root)["compare"]["gap"]["limit"]
    assert read["tokens"] >= 100
    assert read["gap"] <= lim, read
    assert read["control.all.gap_mean"] > 2 * read["gap_mean"], read


def test_row_precision_follows_the_rows_of_each_call():
    from perfbench import compare
    from perfbench.model import model_from_config
    m = model_from_config("m", spec.config("mistral_7b-w4a8"))
    bits, head = compare.row_bits(m, 600, 5, [(0, 512, 512), (512, 88, 128)])
    # a 512-token chunk runs the bf16 kernels, the 88-token tail (bucket
    # 128) too; the decode rows and the head run W4A8
    assert head == 8 and (bits[:600] == 16).all() and (bits[600:] == 8).all()
    bits, _ = compare.row_bits(m, 560, 2, [(0, 512, 512), (512, 48, 64)])
    assert (bits[:512] == 16).all() and (bits[512:] == 8).all()
    # a 40-token prompt alone runs 64 rows, int8; in a batched admission
    # of four (4 x 64 rows) bf16
    bits, _ = compare.row_bits(m, 40, 2, [(0, 40, 64)])
    assert (bits == 8).all()
    bits, _ = compare.row_bits(m, 40, 2, [(0, 40, 256)])
    assert (bits[:40] == 16).all() and (bits[40:] == 8).all()
    s = model_from_config("s", spec.config("starcoder_15.5b-w4a16"))
    bits, head = compare.row_bits(s, 40, 3, [(0, 40, 64)])
    assert head == 16 and (bits == 16).all() and len(bits) == 42


def test_the_sample_spreads_over_requests_slots_and_admissions():
    """Each request gives at most ``per_request`` positions (the longest
    also its last ones); batched and single admissions alternate and the
    slots differ while others are left."""
    from perfbench import drivers, traffic
    mix = spec.traffic("chat")
    done = []
    for i in range(40):
        it = traffic.Item(i, "win", 0.0, np.arange(30 + i), 50 + 10 * i, 0)
        adm = dict(chunks=[(0, 30 + i, 64 if i % 2 else 128)],
                   batched=bool(i % 2), slot=i % 16)
        done.append((it, np.arange(it.n_out), adm))
    out = drivers._pick(done, dict(tokens=500, per_request=32), 7, mix)
    assert sum(len(s["want"]) for s in out) >= 500
    longest = [s for s in out if len(s["served"]) == 440]
    assert len(longest) == 1 and len(longest[0]["want"]) == 64
    assert longest[0]["want"][-1] == 439
    assert all(len(s["want"]) == 32 for s in out if s is not longest[0])
    kinds = [s["batched"] for s in out[1:9]]
    assert kinds == [True, False] * 4
    assert len({s["slot"] for s in out[:8]}) == 8
    assert out[0]["admission"] == [(0, 69, 64)]


def test_penalty_window_matches_the_sampler():
    """The reference's penalized logits equal the port's sampler's at each
    position of a greedy request with a repetition penalty."""
    from perfbench import compare
    from tinychatengine_tpu_torch.generation import sampling
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((5, 50)), dtype=torch.float32)
    prompt = rng.integers(0, 50, 70)
    served = rng.integers(0, 50, 5)
    ctx = np.concatenate([prompt, served])
    s = {"temp": 0.0, "repeat_penalty": 1.1, "repeat_last_n": 64}
    got = compare.penalized(logits, ctx, 70 + np.arange(5), s)
    for j in range(5):
        window = torch.as_tensor(ctx[70 + j - 64:70 + j])[None]
        want = sampling.apply_repetition_penalty(logits[j:j + 1], window, 1.1)
        assert torch.allclose(got[j], want[0], rtol=1e-6)
