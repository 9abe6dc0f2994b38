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


# A fixed set of synthetic calls: decode ticks of 1, 16 and 64 rows at KV
# lengths up to 4096 (and one row past Mistral's window), ("decode", KV
# lengths, rows run); single chunks at starts 0 to 3584, short chunks and
# batched admissions, ("prefill", chunks, rows needing logits, rows run).
GOLDEN_CALLS = (
    [("decode", [1], 1), ("decode", [4096], 1),
     ("decode", [64 + 255 * i for i in range(16)], 16),
     ("decode", [64 + 255 * i for i in range(16)], 64),
     ("decode", [1 + 64 * i for i in range(64)], 64),
     ("decode", [5000, 100], 64)]
    + [("prefill", [(s, 512)], int(s == 3584), 512)
       for s in range(0, 4096, 512)]
    + [("prefill", [(3584, 37)], 1, 64), ("prefill", [(0, 100)], 1, 128),
       ("prefill", [(0, 40), (0, 200), (0, 17), (0, 64)], 4, 1024),
       ("prefill", [(0, 30), (0, 50)], 2, 128),
       ("prefill", [(0, 20), (0, 10)], 2, 64),
       ("prefill", [(0, 8)] * 8, 8, 128)])

# (linear, attention) seconds of each golden call, and of all of them
# summed by ``+=`` in order, as the harness counted them before the
# families moved to families/ (computed on the CPU; float for float)
GOLDEN_BOUNDS = {
    "mistral_7b-w4a8": [
        (0.0010957687976119403, 2.3475582089552238e-07),
        (0.0010957687976119403, 0.00016045560358208955),
        (0.001116046290149254, 0.0012404497576119402),
        (0.001116046290149254, 0.0012404497576119402),
        (0.0011809342662686567, 0.0050632135450746265),
        (0.0010971206304477613, 0.0001645638304477612),
        (0.007226315046050556, 0.00012019498029850746),
        (0.007226315046050556, 0.00020858710610313448),
        (0.007226315046050556, 0.00034755470314256823),
        (0.007226315046050556, 0.000486522300182002),
        (0.007226315046050556, 0.0006254898972214358),
        (0.007226315046050556, 0.0007644574942608696),
        (0.007226315046050556, 0.0009034250913003034),
        (0.007246510924259511, 0.001042392688339737),
        (0.0011436589850746268, 0.0001489134423880597),
        (0.0014315855356407043, 2.347558208955224e-05),
        (0.004550821328117109, 7.535661850746268e-05),
        (0.001200882703283582, 1.878046567164179e-05),
        (0.0011343685540298508, 7.0426746268656715e-06),
        (0.0011797274746268658, 1.5024372537313432e-05),
    ],
    "starcoder_15.5b-w4a16": [
        (0.0023823411964179106, 3.056716417910448e-07),
        (0.0023823411964179106, 2.5340179104477612e-05),
        (0.002413739787462687, 0.0001981241313432836),
        (0.002413739787462687, 0.0001981241313432836),
        (0.0025142152788059707, 0.0008083425432835821),
        (0.0023844344358208954, 3.1777623880597016e-05),
        (0.015698995728048535, 0.00015650388059701493),
        (0.015698995728048535, 0.00039110082394337714),
        (0.015698995728048535, 0.0006516650683923155),
        (0.015698995728048535, 0.0009122293128412538),
        (0.015698995728048535, 0.0011727935572901922),
        (0.015698995728048535, 0.0014333578017391305),
        (0.015698995728048535, 0.0016939220461880688),
        (0.015745510393123163, 0.001954486290637007),
        (0.0024565093635820897, 0.00013250762936299292),
        (0.0031127247682091064, 3.0567164179104476e-05),
        (0.009889148133748247, 9.812059701492537e-05),
        (0.0025451321313432838, 2.4453731343283582e-05),
        (0.0024421207880597016, 9.170149253731343e-06),
        (0.0025123665767164184, 1.9562985074626867e-05),
    ],
}
GOLDEN_SUMS = {
    "mistral_7b-w4a8": (0.07517344589962495, 0.012656584666818706,
                        0.08783003056644366),
    "starcoder_15.5b-w4a16": (0.16308729393350976, 0.00994245531845404,
                              0.1730297492519638),
}


def _bound(m, call, peaks):
    if call[0] == "decode":
        return work.decode_call(m, call[1], peaks, call[2])
    return work.prefill_call(m, call[1], call[2], peaks, call[3])


@pytest.mark.parametrize("name", sorted(GOLDEN_BOUNDS))
def test_bounds_are_the_pinned_floats(name):
    """Each call's ``linear``, ``attention`` and ``total`` are the pinned
    floats exactly (``total`` summed linear first), and ``+=`` over all
    of them gives the pinned sums."""
    m, peaks = _model(name), spec.peaks()
    acc = work.Bound()
    for call, (lin, att) in zip(GOLDEN_CALLS, GOLDEN_BOUNDS[name],
                                strict=True):
        b = _bound(m, call, peaks)
        assert (b.linear, b.attention, b.total) == (lin, att, lin + att), \
            call
        assert list(b) == ["linear", "attention"]
        acc += b
    assert (acc.linear, acc.attention, acc.total) == GOLDEN_SUMS[name]


def test_bound_is_keyed_by_kernel_class():
    """An absent class reads 0 (and is not added by reading); ``+=``
    merges classes; ``total`` sums every class."""
    b = work.Bound(linear=1.0, attention=0.5)
    assert b["expert"] == 0.0 and "expert" not in b
    b += work.Bound(expert=2.0, linear=0.25)
    assert dict(b) == {"linear": 1.25, "attention": 0.5, "expert": 2.0}
    assert b.total == 3.75
    assert work.Bound().total == 0.0 and work.Bound().linear == 0.0


def test_per_layer_windows_count_each_layers_keys():
    """A model whose layers have different windows counts each layer's
    attention over its own keys: the sum of the uniform models' bounds,
    each scaled to its share of the layers."""
    m = _model("mistral_7b-w4a8")
    windows = [1024, 1024, 1024, None] * 8
    kv, chunks = [100, 3000, 4096], [(0, 512), (2048, 512)]
    for fn, arg in ((work.attention_decode, kv),
                    (work.attention_prefill, chunks)):
        mixed = fn(m, arg, PEAKS, windows)
        full = fn(m, arg, PEAKS, [None] * 32)
        slid = fn(m, arg, PEAKS, [1024] * 32)
        assert mixed == pytest.approx(full / 4 + slid * 3 / 4, rel=1e-12)
        assert slid < full


def _hash(*tensors) -> str:
    import hashlib

    import torch
    d = hashlib.blake2b(digest_size=8)
    for t in tensors:
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        d.update(t.numpy().tobytes())
    return d.hexdigest()


# the seed's tensors of the tiny configurations (conftest.TINY_CONFIGS):
# one layer of each linear with its bias, the lm_head, the tables and the
# norms, hashed as the harness made them before the families moved
HASH_SEED = 2 ** 31 + 11
TENSORS = {
    "wqkv/0": lambda w: w.packed("wqkv", 0),
    "wo/1": lambda w: w.packed("wo", 1),
    "wgate_up/0": lambda w: w.packed("wgate_up", 0),
    "down/1": lambda w: w.packed("down", 1),
    "embed": lambda w: [w.table("embed", w.model.vocab)],
    "input_norm": lambda w: [w.norm("input_norm")],
    "post_norm": lambda w: [w.norm("post_norm")],
    "final_norm": lambda w: [w.norm("final_norm", stacked=False)],
    "c_attn/0": lambda w: w.packed("c_attn", 0),
    "c_proj/1": lambda w: w.packed("c_proj", 1),
    "fc_in/0": lambda w: w.packed("fc_in", 0),
    "fc_out/1": lambda w: w.packed("fc_out", 1),
    "c_attn/bias": lambda w: [w.bias("c_attn")],
    "c_proj/bias": lambda w: [w.bias("c_proj")],
    "fc_in/bias": lambda w: [w.bias("fc_in")],
    "fc_out/bias": lambda w: [w.bias("fc_out")],
    "wte": lambda w: [w.table("wte", w.model.vocab)],
    "wpe": lambda w: [w.table("wpe", w.model.positions)],
    "ln1_w": lambda w: [w.norm("ln1_w")],
    "ln1_b": lambda w: [w.norm_bias("ln1_b")],
    "ln2_w": lambda w: [w.norm("ln2_w")],
    "ln2_b": lambda w: [w.norm_bias("ln2_b")],
    "lnf_w": lambda w: [w.norm("lnf_w", stacked=False)],
    "lnf_b": lambda w: [w.norm_bias("lnf_b", stacked=False)],
    "lm_head": lambda w: w.packed("lm_head"),
}
HASHES = {
    "tiny_llama": {
        "wqkv/0": "876d19461cff8da0", "wo/1": "6831cb217d680afd",
        "wgate_up/0": "0164cdae41fac602", "down/1": "31563a3a5721fd42",
        "lm_head": "47f2a68bf23d5bd9", "embed": "c8157f3352e093c5",
        "input_norm": "fbdc89bc8ce2f5a0", "post_norm": "3d7e2bf2c867e687",
        "final_norm": "80dfdd565a20e1a7"},
    "tiny_starcoder": {
        "c_attn/0": "2ea0df0dd5ced8fb", "c_attn/bias": "b18cf3c009973407",
        "c_proj/1": "3fa7063ab178ccd9", "c_proj/bias": "e4b5761670dd6479",
        "fc_in/0": "11c29f61c1e7e61e", "fc_in/bias": "6e923cc10d2f1200",
        "fc_out/1": "d9fdd72b3f3d39cc", "fc_out/bias": "4e5058363595b69b",
        "lm_head": "4ec0e616ac2627ba", "wte": "93863d40d07adf76",
        "wpe": "46c8f3b90ef9cff0", "ln1_w": "43dccc366b5ff268",
        "ln1_b": "4289d20e54881d78", "ln2_w": "edc11cf027e1e1d3",
        "ln2_b": "3eff0f10766b8dde", "lnf_w": "57775324fb8f5761",
        "lnf_b": "50eb6cf58c4ac2e4"},
}


@pytest.mark.parametrize("name", sorted(HASHES))
def test_weights_are_the_pinned_tensors(tiny, name):
    from perfbench.weights import Weights
    _, root = tiny
    m = model_from_config(name, spec.config(name, root), root)
    w = Weights(m, HASH_SEED, "cpu")
    assert {k: _hash(*TENSORS[k](w)) for k in HASHES[name]} == HASHES[name]
