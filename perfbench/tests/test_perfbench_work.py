"""The work and byte functions against counts made by hand at both
configurations' published widths."""

import pytest

from perfbench import spec, work
from perfbench.model import model_from_config

PEAKS = {"bf16_flops_s": 989e12, "int8_ops_s": 1979e12, "hbm_bytes_s": 3.35e12}


def _model(name):
    return model_from_config(name, spec.config(name))


def test_peaks_file_is_the_data_sheet():
    p = spec.peaks()
    assert {k: p[k] for k in PEAKS} == PEAKS


def test_mistral_widths_and_parameters():
    m = _model("mistral_7b-w4a8")
    assert (m.hidden, m.inter, m.heads, m.kv_heads, m.head_dim, m.layers,
            m.vocab, m.window, m.rope_theta) == \
        (4096, 14336, 32, 8, 128, 32, 32000, 4096, 10000.0)
    per_layer = 4096 * 6144 + 4096 * 4096 + 4096 * 28672 + 14336 * 4096
    assert sum(k * n for _, k, n, _ in m.linears()) == per_layer
    assert 32 * per_layer + 4096 * 32000 == 7_110_393_856
    assert m.lm_head_cols == 32768
    assert m.kv_bytes_per_token() == 2 * 8 * 128 * 2


def test_starcoder_widths_and_parameters():
    m = _model("starcoder_15.5b-w4a16")
    assert (m.hidden, m.inter, m.heads, m.kv_heads, m.head_dim, m.layers,
            m.vocab, m.positions) == \
        (6144, 24576, 48, 1, 128, 40, 49152, 8192)
    per_layer = 6144 * 6400 + 6144 * 6144 + 2 * 6144 * 24576
    assert sum(k * n for _, k, n, _ in m.linears()) == per_layer
    assert 40 * per_layer + 6144 * 49152 == 15_464_398_848
    assert m.lm_head_cols == 49152
    assert m.kv_bytes_per_token() == 2 * 1 * 128 * 2


def test_mistral_decode_tick_is_bound_by_the_weights():
    """64 rows of W4A8 decode: every linear reads its int4 weights and
    bf16 scales once; int8 ops are far below the byte time."""
    m = _model("mistral_7b-w4a8")
    rows = 64
    w_bytes = 0
    for _, k, n, _ in m.linears():
        w_bytes += 32 * (k * n / 2 + k // 128 * n * 2 + rows * (k + n) * 2)
    w_bytes += 4096 * 32000 / 2 + 32 * 32000 * 2 + rows * (4096 + 32000) * 2
    got = work.linears(m, rows, rows, PEAKS, call_rows=rows)
    assert got == pytest.approx(w_bytes / 3.35e12, rel=1e-12)
    assert 1.1e-3 < got < 1.25e-3  # 3.67 GB of weights, 0.29 GB of rows


def test_mistral_prefill_chunk_is_bound_by_bf16_operations():
    """A 512-token chunk runs the W4A16 kernels (more than 100 rows):
    2 * rows * K * N operations at bf16's peak."""
    m = _model("mistral_7b-w4a8")
    ops = 2 * 512 * 32 * sum(k * n for _, k, n, _ in m.linears())
    head = max(2 * 4096 * 32000 / 1979e12,
               (4096 * 32000 / 2 + 32 * 32000 * 2 + (4096 + 32000) * 2)
               / 3.35e12)
    assert work.linears(m, 512, 1, PEAKS, 512) == \
        pytest.approx(ops / 989e12 + head, rel=1e-12)


def test_attention_decode_counts_keys_within_the_window():
    m = _model("mistral_7b-w4a8")
    kv = [100, 5000]  # the second row sees only its 4096-key window
    keys = 100 + 4096
    ops = 4 * 4096 * keys
    byt = (keys + 2) * 4096 + 2 * 4096 * 2 * 2
    want = 32 * max(ops / 989e12, byt / 3.35e12)
    assert work.attention_decode(m, kv, PEAKS) == pytest.approx(want)


def test_attention_prefill_counts_the_causal_triangle():
    m = _model("starcoder_15.5b-w4a16")  # no window
    start, take = 1024, 512
    keys = take * start + take * (take + 1) / 2
    ops = 4 * 6144 * keys
    byt = (start + 2 * take) * 512 + take * 6144 * 4
    want = 40 * max(ops / 989e12, byt / 3.35e12)
    assert work.attention_prefill(m, [(start, take)], PEAKS) == \
        pytest.approx(want)
    w = _model("mistral_7b-w4a8")
    # inside the window the triangle is whole
    full = work.attention_prefill(w, [(0, 512)], PEAKS)
    assert full == pytest.approx(32 * max(
        4 * 4096 * (512 * 513 / 2) / 989e12,
        (2 * 512 * 4096 + 512 * 4096 * 4) / 3.35e12))


def test_w4a8_path_follows_the_rows_a_call_runs():
    m = _model("mistral_7b-w4a8")
    a8 = work.linears(m, 64, 0, PEAKS, call_rows=64)
    a16 = work.linears(m, 64, 0, PEAKS, call_rows=128)
    assert a8 == a16  # memory-bound either way at 64 rows
    big8 = work.linears(m, 100, 0, PEAKS, call_rows=100)
    big16 = work.linears(m, 100, 0, PEAKS, call_rows=101)
    assert big8 <= big16
    assert work.bucket(64) == 64 and work.bucket(65) == 128


def test_every_metric_finds_its_reader():
    """A metric's reader is ``metrics/<name>.py``, else the one named by
    its name before the first dot (the suffix names what it moves)."""
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    assert spec.reader("idle_share.tpot").__module__ \
        != spec.reader("mfu.tpot").__module__
    assert (spec.HERE / "metrics" / "idle_share.py").exists()
    assert not (spec.HERE / "metrics" / "idle_share.tpot.py").exists()
