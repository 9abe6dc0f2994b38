"""The port's conversion toolchain against the JAX package's on the same
synthetic sources (CPU twins of tests/test_checkpoint.py's and
tests/test_convert_families.py's conversion cases).

Tolerances: every imported leaf equals JAX's bit for bit (bf16 by its
bits, uint8 / int8 exactly, f32 exactly), except the RoPE tables the
converter computes, which are two libraries' f32 transcendentals (within
2e-6, as tests/test_torch_ops.py holds them); the numerics copies and the
``quantize_linear`` repair are bit-exact; the port's safetensors reader
equals the ``safetensors`` package byte for byte; the CLI's RTN
checkpoints are equal file for file (``meta.json`` and every array)
(``--awq-calib`` in tests/test_torch_awq.py).
"""

import json
import shutil

import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import MODEL_REGISTRY as JREGISTRY
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.quant import numerics as jnum
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu.tools import convert as jcv
from tinychatengine_tpu_torch.core.config import MODEL_REGISTRY
from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.ops.linear import (DenseLinear, Int4A8Linear,
                                                 Int4Linear, W8A8Linear,
                                                 int4_linear_from_codes,
                                                 quantized_linear,
                                                 quantized_linear_kn)
from tinychatengine_tpu_torch.quant import numerics as tnum
from tinychatengine_tpu_torch.tools import checkpoint as tckpt
from tinychatengine_tpu_torch.tools import convert as tcv

LLAMA = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
             num_layers=2, max_sqlen=32, embed_dim=256, hidden_dim=512,
             vocab_size=384, rms_norm_eps=1e-5)
OPT = dict(name="opt_tiny", family="opt", num_heads=4, num_kv_heads=4,
           num_layers=2, max_sqlen=64, embed_dim=256, hidden_dim=512,
           vocab_size=256)
BIGCODE = dict(name="bigcode_tiny", family="gptbigcode", num_heads=4,
               num_kv_heads=1, num_layers=2, max_sqlen=64, embed_dim=256,
               hidden_dim=512, vocab_size=256)
CLIP = dict(name="clip_tiny", family="clip", num_heads=4, num_kv_heads=4,
            num_layers=2, max_sqlen=0, embed_dim=64, hidden_dim=128,
            vocab_size=0, image_size=56, patch_size=14, projection_dim=32,
            mmproj_dim=96)
ROPE = ("rope_cos", "rope_sin")


def _cfgs(d):
    return JModelConfig(**d), ModelConfig(**d)


def _bits(a) -> np.ndarray:
    """A leaf as numpy, bf16 as its uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.kind == "V" or \
        str(a.dtype) == "bfloat16" else a


def assert_tree_equal(port, jax_tree, approx=ROPE):
    """Every leaf of the port's tree equals JAX's bit for bit (same keys,
    dtypes and shapes); the ``approx`` leaves within 2e-6."""
    got, want = tckpt.flatten(port), jckpt._flatten(jax_tree)[0]
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = _bits(got[key]), _bits(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (key, g.dtype, w.dtype, g.shape, w.shape)
        if key in approx:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# ---- numerics and the quantize_linear repair (bit-exact) -----------------

def _awkward_weight(rng, oc, ic):
    """Random weights with the quantizer's corner cases built in: an
    all-zero group, ties of +m and -m in one group (the first maximal |w|
    decides the sign), and values on the code boundaries."""
    w = (rng.standard_normal((oc, ic)) * 0.05).astype(np.float32)
    w[0, :128] = 0.0
    w[1, 3], w[1, 40] = -0.25, 0.25
    w[2, 5], w[2, 9] = 0.25, -0.25
    w[3, :128] = np.linspace(-1.0, 1.0, 128, dtype=np.float32)
    return w


def test_numerics_copies_match_jax():
    rng = np.random.default_rng(0)
    w = _awkward_weight(rng, 64, 256)
    q, s = tnum.quantize_groupwise_int4(w, 128)
    jq, js = jnum.quantize_groupwise_int4(w, 128)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    deq = tnum.dequantize_groupwise_int4(q, s, 128)
    assert deq.dtype == np.float32
    np.testing.assert_array_equal(deq, jnum.dequantize_groupwise_int4(q, s,
                                                                      128))
    for x in (w, np.zeros((3, 5), np.float32),
              rng.standard_normal((7, 9)).astype(np.float32) * 3):
        q8, s8 = tnum.quantize_tensor_int8(x)
        jq8, js8 = jnum.quantize_tensor_int8(x)
        assert q8.dtype == np.int8 and type(s8) is type(js8)
        np.testing.assert_array_equal(q8, jq8)
        assert s8 == js8


@pytest.mark.parametrize("group_size,ic", [(32, 288), (128, 512)])
def test_torch_quantizer_and_packer_match_numpy(group_size, ic):
    """The card's int4 quantizer (``quantize_groupwise_int4_kn``, run here
    on CPU tensors) equals numpy's bit for bit on zero groups, sign ties
    and code boundaries (tests/test_torch_awq.py pins its cast points);
    the torch packers (``quantized_linear_kn``, and ``quantized_linear``
    through it) equal numpy's (``int4_linear_from_codes``)."""
    rng = np.random.default_rng(1)
    w = _awkward_weight(rng, 96, ic)  # [OC, IC]; 288 / 32 groups pad to 16
    q, s = tnum.quantize_groupwise_int4(w, group_size)
    tq, ts = tnum.quantize_groupwise_int4_kn(torch.from_numpy(w.T.copy()),
                                             group_size)
    np.testing.assert_array_equal(tq.numpy(), q.T)
    np.testing.assert_array_equal(ts.numpy(), s.T)
    np.testing.assert_array_equal(
        tnum.dequantize_groupwise_int4_kn(tq, ts, group_size).numpy(),
        tnum.dequantize_groupwise_int4(q, s, group_size).T)
    for sd in ("bf16", "f32"):
        for a8 in (False, True):
            want = int4_linear_from_codes(q, s, group_size, sd, a8=a8)
            for got in (quantized_linear_kn(torch.from_numpy(w).T,
                                            group_size, sd, a8=a8),
                        quantized_linear(w, group_size, sd, a8=a8)):
                assert type(got) is type(want)
                np.testing.assert_array_equal(got.packed.numpy(),
                                              want.packed.numpy())
                np.testing.assert_array_equal(_bits(got.scales),
                                              _bits(want.scales))


@pytest.mark.parametrize("scheme", ["fp", "w4a16", "w4a8"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_quantize_linear_matches_jax(scheme, with_bias):
    """fp: JAX's bf16 DenseLinear stored K-major (bf16 bias); w4a16 / w4a8:
    its biased Int4Linear / Int4A8Linear (f32 bias), bit for bit."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((48, 256)).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32) if with_bias else None
    got = tcv.quantize_linear(w, QuantConfig(scheme=scheme), bias=bias,
                              device="cpu")
    want = jcv.quantize_linear(w, JQuantConfig(scheme=scheme), bias=bias)
    assert type(got).__name__ == type(want).__name__
    assert_tree_equal(got, want)
    if scheme == "fp":
        assert got.weight.shape == (256, 48) and got.weight.is_contiguous()
        assert got.weight.dtype == torch.bfloat16


def test_quantize_linear_refuses_w8a8():
    """Queue 3: JAX's quantize_linear returns an Int4Linear for "w8a8" (a
    llama checkpoint saved under that scheme would be int4); the port
    raises."""
    w = np.zeros((8, 256), np.float32)
    assert type(jcv.quantize_linear(w, JQuantConfig(scheme="w8a8"))
                ).__name__ == "Int4Linear"
    with pytest.raises(ValueError, match="no int4 layout"):
        tcv.quantize_linear(w, QuantConfig(scheme="w8a8"), device="cpu")


# ---- safetensors --------------------------------------------------------

def test_safetensors_reader_matches_package(tmp_path):
    """The port's numpy reader against the installed ``safetensors``
    package: every stored dtype byte for byte, bf16 widened by its bits."""
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as load_torch
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(3)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "f64": rng.standard_normal((2, 2, 2)),
        "i8": rng.integers(-128, 128, (6,), dtype=np.int8),
        "u8": rng.integers(0, 256, (2, 3), dtype=np.uint8),
        "i32": rng.integers(-9, 9, (5,), dtype=np.int32),
        "i64": rng.integers(-9, 9, (1, 4), dtype=np.int64),
        "b": rng.integers(0, 2, (7,)).astype(bool),
        "scalar": np.asarray(1.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    save_file(arrays, str(tmp_path / "a.safetensors"),
              metadata={"format": "np"})
    f = tcv.SafetensorsFile(tmp_path / "a.safetensors")
    want = load_file(str(tmp_path / "a.safetensors"))
    assert sorted(f.keys()) == sorted(want)
    for k, v in want.items():
        got = f.raw(k)
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)

    bf = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)
                          * 1e3).to(torch.bfloat16)
    save_torch({"bf16": bf, "f32": bf.float()}, str(tmp_path / "b.safetensors"))
    f = tcv.SafetensorsFile(tmp_path / "b.safetensors")
    t = load_torch(str(tmp_path / "b.safetensors"))
    np.testing.assert_array_equal(
        f.raw("bf16"), t["bf16"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(f.get_f32("bf16"), t["bf16"].float().numpy())
    np.testing.assert_array_equal(f.get_f32("f32"), t["f32"].numpy())


def test_chip_smoke_safetensors_writer_without_the_package(tmp_path,
                                                           monkeypatch):
    """chip_smoke.py's own safetensors writer (taken where the package is
    absent, as on the card's machine) writes what the package reads, and
    the port's reader reads it back."""
    import sys

    import chip_smoke
    from safetensors.torch import load_file
    t = {"a": torch.randn(3, 5).to(torch.bfloat16), "b": torch.randn(7),
         "c": torch.randn(2, 2).half()}
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    chip_smoke.write_safetensors(tmp_path / "x.safetensors", t)
    monkeypatch.undo()
    back = load_file(str(tmp_path / "x.safetensors"))
    f = tcv.SafetensorsFile(tmp_path / "x.safetensors")
    for k, v in t.items():
        assert torch.equal(back[k], v)
        np.testing.assert_array_equal(f.get_f32(k), v.float().numpy())


# ---- Hugging Face llama -------------------------------------------------

def _hf_llama_tensors(cfg, rng, tied: bool, motif: bool = False) -> dict:
    """An HF llama state dict [OC, IC] with random f32 weights; ``motif``
    builds in AWQ's salient channels (tests/test_awq.py's motif: large norm
    weights on a few channels whose weight rows are small)."""
    e, f, v = cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.head_dim
    t = {"model.embed_tokens.weight": rng.standard_normal((v, e)) * 0.5,
         "model.norm.weight": 1 + 0.1 * rng.standard_normal(e)}
    if not tied:
        t["lm_head.weight"] = rng.standard_normal((v, e)) * 0.05
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes = {"self_attn.q_proj": (e, e), "self_attn.k_proj": (kv, e),
                  "self_attn.v_proj": (kv, e), "self_attn.o_proj": (e, e),
                  "mlp.gate_proj": (f, e), "mlp.up_proj": (f, e),
                  "mlp.down_proj": (e, f)}
        for name, shape in shapes.items():
            t[p + name + ".weight"] = rng.standard_normal(shape) * 0.05
        for n in ("input_layernorm", "post_attention_layernorm"):
            t[p + n + ".weight"] = 1 + 0.1 * rng.standard_normal(e)
        if motif:
            ch = rng.choice(e, 8, replace=False)
            for n in ("input_layernorm", "post_attention_layernorm"):
                t[p + n + ".weight"][ch] *= 20.0
            for n in ("self_attn.q_proj", "self_attn.k_proj",
                      "self_attn.v_proj", "mlp.gate_proj", "mlp.up_proj"):
                t[p + n + ".weight"][:, ch] *= 0.05
    return {k: np.asarray(a, np.float32) for k, a in t.items()}


def write_hf(root, tensors: dict, fmt: str, bf16: bool = False,
             shards: int = 1):
    """The state dict as ``model*.safetensors`` shards (f32, or bf16 through
    torch) or as ``pytorch_model.bin``."""
    root.mkdir(parents=True, exist_ok=True)
    ts = {k: torch.from_numpy(v.copy()) for k, v in tensors.items()}
    if bf16:
        ts = {k: v.to(torch.bfloat16) for k, v in ts.items()}
    if fmt == "bin":
        torch.save(ts, root / "pytorch_model.bin")
        return
    from safetensors.torch import save_file
    keys = sorted(ts)
    for j in range(shards):
        save_file({k: ts[k] for k in keys[j::shards]},
                  str(root / f"model-{j:05d}.safetensors"))


@pytest.mark.parametrize("fmt,tied,bf16,scheme", [
    ("safetensors", False, False, "w4a16"),
    ("safetensors", True, True, "w4a8"),
    ("safetensors", False, True, "fp"),
    ("bin", True, True, "w4a8"),
])
def test_hf_llama_import_matches_jax(tmp_path, fmt, tied, bf16, scheme):
    jcfg, cfg = _cfgs(LLAMA)
    t = _hf_llama_tensors(cfg, np.random.default_rng(4), tied)
    write_hf(tmp_path / "hf", t, fmt, bf16=bf16, shards=2)
    got = tcv.convert_hf_llama(str(tmp_path / "hf"), cfg,
                               QuantConfig(scheme=scheme, group_size=64),
                               device="cpu")
    want = jcv.convert_hf_llama(str(tmp_path / "hf"), jcfg,
                                JQuantConfig(scheme=scheme, group_size=64))
    assert_tree_equal(got, want)
    kind = {"fp": DenseLinear, "w4a16": Int4Linear, "w4a8": Int4A8Linear}
    assert type(got.lm_head) is kind[scheme]


def test_hf_llama_tp_refused(tmp_path):
    _, cfg = _cfgs(LLAMA)
    write_hf(tmp_path, _hf_llama_tensors(cfg, np.random.default_rng(5),
                                         False), "safetensors")
    with pytest.raises(NotImplementedError, match="tp_degree=2"):
        tcv.convert_hf_llama(str(tmp_path), cfg, QuantConfig(), tp_degree=2,
                             device="cpu")
    with pytest.raises(FileNotFoundError):
        tcv.convert_hf_llama(str(tmp_path / "none"), cfg, QuantConfig(),
                             device="cpu")


# ---- the reference's exports (llama) ------------------------------------

def _reference_trees(tmp_path, layout, offset=0.0):
    from test_checkpoint import (_quantize_ref_int4_tree,
                                 _write_reference_export)
    fp_root = tmp_path / "fp"
    fp_root.mkdir()
    _write_reference_export(fp_root, JModelConfig(**LLAMA),
                            np.random.default_rng(7))
    q_root = tmp_path / "int4"
    _quantize_ref_int4_tree(fp_root, q_root, layout, offset=offset)
    return fp_root, q_root


@pytest.mark.parametrize("layout", ["QM_x86", "QM_ARM"])
@pytest.mark.parametrize("scheme", ["w4a16", "w4a8"])
def test_reference_llama_import_matches_jax(tmp_path, layout, scheme):
    """The FP32 export and the no-offset INT4 export (QM_x86, QM_ARM),
    each equal to JAX's import bit for bit; the INT4 tree also equals the
    FP32 tree's at group 32 (tests/test_checkpoint.py's case)."""
    jcfg, cfg = _cfgs(LLAMA)
    fp_root, q_root = _reference_trees(tmp_path, layout)
    q, jq = (QuantConfig(scheme=scheme, group_size=32),
             JQuantConfig(scheme=scheme, group_size=32))
    fp = tcv.convert_reference_llama(str(fp_root), cfg, q, device="cpu")
    assert_tree_equal(fp, jcv.convert_reference_llama(str(fp_root), jcfg, jq))
    got = tcv.convert_reference_llama(str(q_root), cfg, q, ref_layout=layout,
                                      device="cpu")
    assert_tree_equal(got, jcv.convert_reference_llama(
        str(q_root), jcfg, jq, ref_layout=layout))
    for a, b in zip(tckpt.flatten(fp).values(), tckpt.flatten(got).values()):
        assert torch.equal(a, b)


def test_reference_int4_offsets_warn_and_match_jax(tmp_path):
    """An offset-bearing export warns and requantizes the with-offset
    weight: the port's requantized bytes equal JAX's."""
    jcfg, cfg = _cfgs(LLAMA)
    _, q_root = _reference_trees(tmp_path, "QM_x86", offset=0.013)
    e = cfg.embed_dim
    with pytest.warns(UserWarning, match="non-trivial zero_point/offset"):
        kind, w, _ = tcv.read_reference_int4(
            q_root / "decoder/layer0/self_attn/q_proj", e, e)
    with pytest.warns(UserWarning):
        _, jw, _ = jcv.read_reference_int4(
            q_root / "decoder/layer0/self_attn/q_proj", e, e)
    assert kind == "fp"
    np.testing.assert_array_equal(w, jw)
    q = QuantConfig(scheme="w4a16", group_size=64)
    with pytest.warns(UserWarning):
        got = tcv.convert_reference_llama(str(q_root), cfg, q, device="cpu")
    with pytest.warns(UserWarning):
        want = jcv.convert_reference_llama(
            str(q_root), jcfg, JQuantConfig(scheme="w4a16", group_size=64))
    assert_tree_equal(got, want)
    with pytest.raises(ValueError, match="QM_CUDA"):
        tcv.read_reference_int4(q_root / "lm_head", 4, 4, "QM_CUDA")
    with pytest.raises(ValueError, match="only convert to"):
        tcv.convert_reference_llama(str(q_root), cfg, QuantConfig(scheme="fp"),
                                    device="cpu")


# ---- OPT ------------------------------------------------------------------

def _hf_opt_tensors(cfg, rng) -> dict:
    e, f, v = cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size
    t = {"model.decoder.embed_tokens.weight": rng.standard_normal((v, e)),
         "model.decoder.embed_positions.weight":
             rng.standard_normal((cfg.max_sqlen + 2, e)),
         "model.decoder.final_layer_norm.weight": 1 + rng.standard_normal(e),
         "model.decoder.final_layer_norm.bias": rng.standard_normal(e)}
    for i in range(cfg.num_layers):
        p = f"model.decoder.layers.{i}."
        for name, (k, n) in {"self_attn.q_proj": (e, e),
                             "self_attn.k_proj": (e, e),
                             "self_attn.v_proj": (e, e),
                             "self_attn.out_proj": (e, e), "fc1": (e, f),
                             "fc2": (f, e)}.items():
            t[p + name + ".weight"] = rng.standard_normal((n, k)) * 0.05
            t[p + name + ".bias"] = rng.standard_normal(n) * 0.01
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            t[p + ln + ".weight"] = 1 + 0.1 * rng.standard_normal(e)
            t[p + ln + ".bias"] = 0.1 * rng.standard_normal(e)
    return {k: np.asarray(a * 0.1, np.float32) for k, a in t.items()}


@pytest.mark.parametrize("scheme", ["fp", "w4a16", "w4a8"])
def test_hf_opt_import_matches_jax(tmp_path, scheme):
    jcfg, cfg = _cfgs(OPT)
    write_hf(tmp_path, _hf_opt_tensors(cfg, np.random.default_rng(8)),
             "safetensors")
    got = tcv.convert_hf_opt(str(tmp_path), cfg, QuantConfig(scheme=scheme),
                             device="cpu")
    want = jcv.convert_hf_opt(str(tmp_path), jcfg, JQuantConfig(scheme=scheme))
    assert_tree_equal(got, want, approx=())


@pytest.mark.parametrize("int8", [True, False])
def test_reference_opt_import_matches_jax(tmp_path, int8):
    """The SmoothQuant INT8 export (tests/test_convert_families.py's tree)
    and an FP32 export of the same layout."""
    from test_convert_families import _write_reference_opt_int8
    jcfg, cfg = _cfgs(OPT)
    _write_reference_opt_int8(tmp_path, jcfg, np.random.default_rng(9))
    if not int8:  # the FP32 layout: f32 weights where the int8 ones were
        rng = np.random.default_rng(10)
        for p in tmp_path.rglob("weight.bin"):
            n = p.stat().st_size
            if "layer" in str(p) and "norm" not in str(p):
                (rng.standard_normal(n) * 0.02).astype(np.float32).tofile(p)
        for p in tmp_path.rglob("bias_int8.bin"):
            (rng.standard_normal(p.stat().st_size) * 0.01).astype(
                np.float32).tofile(p.with_name("bias.bin"))
    got = tcv.convert_reference_opt(str(tmp_path), cfg, int8=int8,
                                    device="cpu")
    want = jcv.convert_reference_opt(str(tmp_path), jcfg, int8=int8)
    assert_tree_equal(got, want, approx=())
    if int8:
        assert isinstance(got.layers.q_proj, W8A8Linear)
        assert got.layers.q_proj.weight.stride(-2) == 1  # N-major


# ---- GPTBigCode -------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["fp", "w4a16"])
def test_hf_and_reference_gptbigcode_match_jax(tmp_path, scheme):
    from test_convert_families import _write_hf_bigcode, _write_reference_bigcode
    jcfg, cfg = _cfgs(BIGCODE)
    (tmp_path / "hf").mkdir()
    t = _write_hf_bigcode(tmp_path / "hf", jcfg, np.random.default_rng(11))
    _write_reference_bigcode(tmp_path / "ref", jcfg, t)
    q, jq = QuantConfig(scheme=scheme), JQuantConfig(scheme=scheme)
    got = tcv.convert_hf_gptbigcode(str(tmp_path / "hf"), cfg, q, device="cpu")
    assert_tree_equal(got, jcv.convert_hf_gptbigcode(str(tmp_path / "hf"),
                                                     jcfg, jq), approx=())
    ref = tcv.convert_reference_gptbigcode(str(tmp_path / "ref"), cfg, q,
                                           device="cpu")
    assert_tree_equal(ref, jcv.convert_reference_gptbigcode(
        str(tmp_path / "ref"), jcfg, jq), approx=())
    assert torch.equal(ref.layers.c_attn.bias, got.layers.c_attn.bias)


# ---- CLIP ---------------------------------------------------------------------

@pytest.mark.parametrize("mm", [True, False])
def test_hf_and_reference_clip_match_jax(tmp_path, mm):
    from test_convert_families import _write_hf_clip, _write_reference_clip
    jcfg, cfg = _cfgs(CLIP)
    (tmp_path / "hf").mkdir()
    t = _write_hf_clip(tmp_path / "hf", jcfg, np.random.default_rng(12))
    _write_reference_clip(tmp_path / "ref", jcfg, t)
    if not mm:
        for idx in (0, 2):
            shutil.rmtree(tmp_path / "ref" / f"mm_projector_{idx}")
    mm_src = str(tmp_path / "hf") if mm else None
    got = tcv.convert_hf_clip(str(tmp_path / "hf"), cfg, mm_proj_src=mm_src,
                              device="cpu")
    assert_tree_equal(got, jcv.convert_hf_clip(str(tmp_path / "hf"), jcfg,
                                               mm_proj_src=mm_src), approx=())
    ref = tcv.convert_reference_clip(str(tmp_path / "ref"), cfg, device="cpu")
    assert_tree_equal(ref, jcv.convert_reference_clip(str(tmp_path / "ref"),
                                                      jcfg), approx=())


# ---- the command lines ----------------------------------------------------------

def _read_ckpt(path):
    meta = json.loads((path / "meta.json").read_text())
    flat = {}
    for fname in sorted(set(meta["index"].values())):
        with np.load(path / fname) as z:
            flat.update({k: z[k] for k in z.files})
    return meta, flat


def assert_ckpt_equal(a, b, approx=("rope_cos", "rope_sin"), tol=None):
    """Two checkpoint directories: equal meta.json and arrays (the
    ``approx`` keys within 2e-6; with ``tol`` the bf16 / f32 arrays within
    ``tol`` of their largest magnitude)."""
    ma, fa = _read_ckpt(a)
    mb, fb = _read_ckpt(b)
    assert ma == mb
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        name = k.replace("|", "/")
        if name in approx:
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-6, err_msg=k)
        elif tol is not None and name in ma["dtypes"]:
            xf, yf = (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                      .float().numpy() for v in (x, y))
            assert np.abs(xf - yf).max() <= tol * np.abs(yf).max(), k
        elif tol is None:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture
def registered(monkeypatch):
    """The tiny llama under one name in both registries."""
    jcfg, cfg = _cfgs(dict(LLAMA, name="convert_cli_tiny"))
    monkeypatch.setitem(JREGISTRY, "convert_cli_tiny", jcfg)
    monkeypatch.setitem(MODEL_REGISTRY, "convert_cli_tiny", cfg)
    return jcfg, cfg


@pytest.mark.parametrize("scheme", ["w4a8", "fp"])
def test_convert_cli_matches_jax(tmp_path, registered, scheme):
    """``python -m tinychatengine_tpu_torch.tools.convert`` and JAX's
    ``main`` on one HF directory write equal checkpoints (RTN)."""
    _, cfg = registered
    write_hf(tmp_path / "hf", _hf_llama_tensors(cfg, np.random.default_rng(13),
                                                True), "safetensors")
    args = ["--model", "convert_cli_tiny", "--src", str(tmp_path / "hf"),
            "--scheme", scheme, "--group-size", "64"]
    tcv.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jcv.main(args + ["--out", str(tmp_path / "jax")])
    assert_ckpt_equal(tmp_path / "port", tmp_path / "jax")
    params, qcfg = tckpt.load_checkpoint(str(tmp_path / "port"), device="cpu")
    assert qcfg.scheme == scheme
    assert tcv.build_parser().parse_args(
        ["--model", "m", "--src", "s", "--out", "o"]).device == "cuda"


def test_convert_cli_reference_export_matches_jax(tmp_path, registered):
    """The CLI on a reference INT4 export (QM_ARM) writes JAX's
    checkpoint."""
    from test_checkpoint import (_quantize_ref_int4_tree,
                                 _write_reference_export)
    jcfg, _ = registered
    _write_reference_export(tmp_path / "fp", jcfg, np.random.default_rng(14))
    _quantize_ref_int4_tree(tmp_path / "fp", tmp_path / "int4", "QM_ARM")
    args = ["--model", "convert_cli_tiny", "--src", str(tmp_path / "int4"),
            "--ref-layout", "QM_ARM", "--scheme", "w4a8"]
    tcv.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jcv.main(args + ["--out", str(tmp_path / "jax")])
    assert_ckpt_equal(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("family", ["opt", "opt_int8", "gptbigcode", "clip"])
def test_convert_cli_families_match_jax(tmp_path, monkeypatch, family):
    """The CLI on the other families' sources (HF OPT to w4a16, the
    reference's OPT INT8 export to w8a8, HF GPTBigCode to w4a16, HF CLIP to
    the ``clip`` sub-checkpoint) writes JAX's checkpoint."""
    from test_convert_families import (_write_hf_bigcode, _write_hf_clip,
                                       _write_reference_opt_int8)
    d = {"opt": OPT, "opt_int8": OPT, "gptbigcode": BIGCODE,
         "clip": CLIP}[family]
    jcfg, cfg = _cfgs(dict(d, name="cli_" + family))
    monkeypatch.setitem(JREGISTRY, cfg.name, jcfg)
    monkeypatch.setitem(MODEL_REGISTRY, cfg.name, cfg)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(20)
    scheme = "w4a16"
    if family == "opt":
        write_hf(src, _hf_opt_tensors(cfg, rng), "safetensors")
    elif family == "opt_int8":
        _write_reference_opt_int8(src, jcfg, rng)
        scheme = "w8a8"
    elif family == "gptbigcode":
        _write_hf_bigcode(src, jcfg, rng)
    else:
        _write_hf_clip(src, jcfg, rng)
    args = ["--model", cfg.name, "--src", str(src), "--scheme", scheme]
    tcv.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jcv.main(args + ["--out", str(tmp_path / "jax")])
    sub = "clip" if family == "clip" else ""
    assert_ckpt_equal(tmp_path / "port" / sub, tmp_path / "jax" / sub)


def test_convert_cli_refusals(tmp_path, registered):
    _, cfg = registered
    write_hf(tmp_path, _hf_llama_tensors(cfg, np.random.default_rng(17),
                                         True), "safetensors")
    base = ["--model", "convert_cli_tiny", "--src", str(tmp_path), "--out",
            str(tmp_path / "o"), "--device", "cpu"]
    with pytest.raises(SystemExit):  # AWQ needs an int4 scheme
        tcv.main(base + ["--scheme", "fp", "--awq-calib", "x.npy"])
    with pytest.raises(NotImplementedError, match="tp_degree"):
        tcv.main(base + ["--tp", "2"])


def test_load_awq_calib_matches_jax(tmp_path):
    _, cfg = _cfgs(LLAMA)
    ids = np.random.default_rng(18).integers(0, 300, 1500)
    np.save(tmp_path / "c.npy", ids)
    for n in (1, 2, 4):
        np.testing.assert_array_equal(
            tcv._load_awq_calib(str(tmp_path / "c.npy"), "", cfg, n),
            jcv._load_awq_calib(str(tmp_path / "c.npy"), "", cfg, n))
    (tmp_path / "t.txt").write_text("hello world " * 30)
    np.testing.assert_array_equal(
        tcv._load_awq_calib(str(tmp_path / "t.txt"), str(tmp_path), cfg, 4),
        jcv._load_awq_calib(str(tmp_path / "t.txt"), str(tmp_path), cfg, 4))


def test_calibrate_opt_cli_matches_jax(tmp_path):
    """``python -m tinychatengine_tpu_torch.tools.calibrate_opt`` against
    JAX's ``main`` on assets/byteopt_4m: equal meta.json; the W8A8 arrays
    within the OPT requant tolerance (ROADMAP Queue 3): int8 weights equal
    but for a handful of codes one apart, f32 alphas, LN folds and biases
    within 1e-6 relative... here within 1e-3 relative, since the two
    statistics passes round the activations' absmax differently."""
    from pathlib import Path
    ckpt = Path(__file__).resolve().parent.parent / "assets" / "byteopt_4m"
    if not (ckpt / "meta.json").exists():
        pytest.skip("trained OPT checkpoint not present")
    from tinychatengine_tpu.tools import calibrate_opt as jcal
    from tinychatengine_tpu_torch.tools import calibrate_opt as tcal
    calib = tmp_path / "calib.txt"
    calib.write_text((ckpt / "eval_sample.txt").read_text()[:3000])
    args = ["--model", "byteopt_4m", "--checkpoint", str(ckpt),
            "--calib-text", str(calib), "--calib-tokens", "128"]
    tcal.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jcal.main(args + ["--out", str(tmp_path / "jax")])
    ma, fa = _read_ckpt(tmp_path / "port")
    mb, fb = _read_ckpt(tmp_path / "jax")
    assert ma == mb and sorted(fa) == sorted(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype == np.int8:
            diff = np.abs(x.astype(int) - y.astype(int))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, k
        elif x.dtype == np.float32:
            np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_converters_default_to_the_card(tmp_path, monkeypatch):
    """Without ``device`` every converter asks for the card (here, with
    none: the resolve_device error); the CLIs default to --device cuda."""
    _, cfg = _cfgs(LLAMA)
    write_hf(tmp_path, _hf_llama_tensors(cfg, np.random.default_rng(19),
                                         True), "safetensors")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.zeros((8, 256), np.float32)
    for call in (lambda: tcv.quantize_linear(w, QuantConfig(scheme="fp")),
                 lambda: tcv.convert_hf_llama(str(tmp_path), cfg,
                                              QuantConfig()),
                 lambda: tcv.convert_reference_llama(str(tmp_path), cfg,
                                                     QuantConfig()),
                 lambda: tcv.convert_hf_opt(str(tmp_path), cfg, QuantConfig()),
                 lambda: tcv.convert_reference_opt(str(tmp_path), cfg),
                 lambda: tcv.convert_hf_gptbigcode(str(tmp_path), cfg,
                                                   QuantConfig()),
                 lambda: tcv.convert_reference_gptbigcode(str(tmp_path), cfg,
                                                          QuantConfig()),
                 lambda: tcv.convert_hf_clip(str(tmp_path), cfg),
                 lambda: tcv.convert_reference_clip(str(tmp_path), cfg),
                 lambda: tcv.main(["--model", "bytellama_5m", "--src",
                                   str(tmp_path), "--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_convert_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 15 (``convert_path``) at a tiny width and 2
    layers on the CPU, its checks as on the card but for those that need
    the kernels or the card's sizes (launch counts, no plain version, qkv /
    gate_up's AWQ gain on the motif, bytellama's Delta ppl on 1024 tokens):
    the synthetic HF shards, the RTN import against numpy's
    quantize_linear, AWQ and its host twin, the checkpoint round trip
    through the Engine against the CPU forward, bytellama_5m through the
    convert CLI (1 calibration window) and the native checks."""
    import chip_smoke
    tiny = ModelConfig(**dict(LLAMA, name="llama3_8b_tiny", vocab_size=300,
                              max_sqlen=128))
    out = chip_smoke.convert_path(dev="cpu", model=tiny, n_layers=2,
                                  n_windows=1, window=64, eval_tokens=1024,
                                  n_predict=4)
    assert out["graph_eq_eager"] and out["wo_host"]["s_equal"]
    assert set(out["wo_host"]["faulted_loss_rel"]) == {"div", "fma", "s32"}
    assert out["w4a16_prefill_vs_cpu"] == out["w4a16_first_step_vs_cpu"] == 0
    assert out["native"]["ids_equal"]
    assert out["awq_launches"] == dict.fromkeys(out["awq_launches"], 0)
    assert set(out["seconds"]) >= {"write", "read", "convert_per_layer",
                                   "awq_calibration", "awq_search",
                                   "requantize_save_load"}
