"""Model conversion: Hugging Face checkpoints and the reference's exported
``.bin`` trees → ``tinychatengine_tpu.v1`` parameter trees (counterpart of
the JAX package's ``tools/convert.py``).

One step, one layout: the quantizer and the QM_TPU packer are bit-exact
copies of the JAX package's (``quant/numerics.py``, ``quant/packing.py``),
so the packed bytes and bf16 leaves equal the JAX package's for the same
source. The four families (llama, OPT, GPTBigCode, CLIP) import from
Hugging Face shards and from the reference's export trees; ``--awq-calib``
runs the AWQ scale search (``quant/awq.py``) before int4 quantization.

Hugging Face shards: ``*.safetensors`` are read here with numpy (an 8-byte
little-endian header length, a JSON header, then raw little-endian
tensors; bf16 widened to f32 by its bits), so the ``safetensors`` package
is not needed; ``pytorch_model*.bin`` through ``torch.load(weights_only=
True)``. Every entry point builds its tree on ``device`` (``None``: the
card, raising without one); int4 quantization runs in numpy on the host for
a CPU tree and in torch on the card otherwise, with the same bytes.

Usage:
    python -m tinychatengine_tpu_torch.tools.convert --model llama3_8b \\
        --src /path/to/hf_or_bin_dir --out /path/to/ckpt \\
        [--scheme w4a16 --group-size 128] [--awq-calib calib.npy] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import struct
import warnings
from pathlib import Path

import numpy as np
import torch

from tinychatengine_tpu_torch import native
from tinychatengine_tpu_torch.core.config import (ModelConfig, QuantConfig,
                                                  get_model_config)
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.models import clip, gptbigcode, llama, opt
from tinychatengine_tpu_torch.models.llama import LlamaLayerParams, LlamaParams
from tinychatengine_tpu_torch.ops import ref as opsref
from tinychatengine_tpu_torch.ops.linear import (DenseLinear, W8A8Linear,
                                                 fuse_linears,
                                                 int4_linear_from_codes,
                                                 quantized_linear,
                                                 quantized_linear_kn)
from tinychatengine_tpu_torch.quant.packing import ZERO_POINT_CODE

stack_layers = opt.stack_layers  # per-layer trees -> one tree stacked [L, ...]


def _tensor(a, dev, dtype=torch.float32) -> torch.Tensor:
    """A numpy array (f32 on the host) as a ``dtype`` tensor on ``dev``;
    bf16 rounds to nearest even, as ``jnp.asarray(a, jnp.bfloat16)``."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return t.to(dtype)


def _kmajor(w_oc_ic: np.ndarray, dev, dtype=torch.float32) -> torch.Tensor:
    """w [OC, IC] as the K-major [IC, OC] ``dtype`` weight on ``dev``."""
    return _tensor(w_oc_ic, dev, dtype).T.contiguous()


def _single_device(tp_degree: int) -> None:
    if tp_degree != 1:
        raise NotImplementedError(
            f"tp_degree={tp_degree}: the port fuses qkv / gate_up for one "
            "device only (its parallel layer is not ported)")


def quantize_linear(w_oc_ic: np.ndarray, qcfg: QuantConfig,
                    bias: np.ndarray | None = None, device=None):
    """w [OC, IC] float → ``DenseLinear`` (scheme fp: the bf16 weight stored
    K-major, a bf16 bias) or ``Int4Linear`` / ``Int4A8Linear`` (QM_TPU, an
    f32 bias), on ``device`` (``None``: the card, raising without one)."""
    dev = resolve_device(device)
    if qcfg.scheme == "fp":
        return DenseLinear(
            weight=_kmajor(w_oc_ic, dev, torch.bfloat16),
            bias=None if bias is None else _tensor(bias, dev, torch.bfloat16))
    if qcfg.scheme not in ("w4a16", "w4a8"):
        raise ValueError(f"no int4 layout for scheme {qcfg.scheme!r}")
    lin = quantized_linear(w_oc_ic, qcfg.group_size, qcfg.scale_dtype,
                           a8=qcfg.scheme == "w4a8", device=dev)
    lin.bias = None if bias is None else _tensor(bias, dev)
    return lin


def requantize_llama(params: LlamaParams, qcfg: QuantConfig) -> LlamaParams:
    """fp LlamaParams → w4a16 / w4a8 LlamaParams on the same device, with
    conversion-time numerics. Groups run along K per output column, so
    quantizing the fused qkv / gate-up matrices equals quantizing before
    fusion. The weights are quantized where they lie
    (``quantized_linear_kn``), with numpy's bytes."""
    if qcfg.scheme == "fp":
        return params
    lyr = params.layers

    def qlin(w: torch.Tensor, bias):
        return quantized_linear_kn(w.float(), qcfg.group_size,
                                   qcfg.scale_dtype, a8=qcfg.scheme == "w4a8",
                                   bias=None if bias is None else bias.float())

    def qlin_stacked(p):
        return stack_layers([
            qlin(p.weight[i], None if p.bias is None else p.bias[i])
            for i in range(p.weight.shape[0])])

    for p in (lyr.wqkv, lyr.wo, lyr.wgate_up, lyr.down, params.lm_head):
        if not isinstance(p, DenseLinear):
            raise ValueError("requantize expects an fp llama tree")

    return LlamaParams(
        embed=params.embed,
        layers=LlamaLayerParams(
            input_norm=lyr.input_norm, wqkv=qlin_stacked(lyr.wqkv),
            wo=qlin_stacked(lyr.wo), post_norm=lyr.post_norm,
            wgate_up=qlin_stacked(lyr.wgate_up), down=qlin_stacked(lyr.down)),
        final_norm=params.final_norm,
        lm_head=qlin(params.lm_head.weight, params.lm_head.bias),
        rope_cos=params.rope_cos, rope_sin=params.rope_sin)


# ---------------------------------------------------------------------------
# Hugging Face source
# ---------------------------------------------------------------------------

# safetensors dtype names -> little-endian numpy dtypes (bf16 as its bits)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
              "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
              "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1",
              "BOOL": "?"}


class SafetensorsFile:
    """One ``*.safetensors`` file read with numpy: an 8-byte little-endian
    header length, a JSON header (name -> dtype, shape, data_offsets from
    the end of the header), then the raw little-endian tensors. A tensor is
    read on request (``native.read_file``, the threaded pread)."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.base = 8 + n
        self.entries = header

    def keys(self):
        return self.entries.keys()

    def dtype(self, name: str) -> str:
        return self.entries[name]["dtype"]

    def raw(self, name: str) -> np.ndarray:
        """The stored array (BF16 as its uint16 bit patterns)."""
        e = self.entries[name]
        if e["dtype"] not in _ST_DTYPES:
            raise NotImplementedError(f"{name}: safetensors dtype "
                                      f"{e['dtype']}")
        dt = np.dtype(_ST_DTYPES[e["dtype"]])
        lo, hi = e["data_offsets"]
        a = native.read_file(self.path, dt, count=(hi - lo) // dt.itemsize,
                             offset=self.base + lo)
        return a.reshape(e["shape"])

    def get_f32(self, name: str) -> np.ndarray:
        """The tensor as f32: bf16 widened by its bits (each u16 into the
        high half of a u32: torch's exact bf16 -> f32 cast, on all of the
        host's threads), other floats cast."""
        a = self.raw(name)
        if self.dtype(name) == "BF16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return t.float().numpy()
        return np.asarray(a, np.float32)


def _hf_state_dict_loader(src: str):
    """Returns name → np.ndarray(float32) over safetensors/bin shards."""
    p = Path(src)
    st_files = sorted(p.glob("*.safetensors"))
    if st_files:
        files = [SafetensorsFile(f) for f in st_files]
        key_to_f = {k: f for f in files for k in f.keys()}

        def get(name):
            if name not in key_to_f:
                raise KeyError(name)
            return key_to_f[name].get_f32(name)
        return get

    bins = sorted(p.glob("pytorch_model*.bin"))
    if bins:
        maps = [torch.load(str(f), map_location="cpu", weights_only=True)
                for f in bins]

        def get(name):
            for m in maps:
                if name in m:
                    return m[name].float().numpy()
            raise KeyError(name)
        return get
    raise FileNotFoundError(f"no safetensors/bin shards under {src}")


def _padded_head(w: np.ndarray) -> np.ndarray:
    """The lm_head [V, E] with zero rows up to ``llama.lmhead_padded(V)``
    (a tile-friendly N; the forward slices the logits back)."""
    vp = llama.lmhead_padded(w.shape[0])
    if vp == w.shape[0]:
        return w
    return np.concatenate([w, np.zeros((vp - w.shape[0], w.shape[1]),
                                       w.dtype)])


def convert_hf_llama(src: str, cfg: ModelConfig, qcfg: QuantConfig,
                     tp_degree: int = 1, device=None) -> LlamaParams:
    """HF LlamaForCausalLM/MistralForCausalLM state dict → LlamaParams on
    ``device``. Tensors are read lazily, one at a time; the lm_head falls
    back to the embedding when the checkpoint ties them."""
    _single_device(tp_degree)
    dev = resolve_device(device)
    sd = _hf_state_dict_loader(src)

    def lin(name):
        return quantize_linear(sd(name), qcfg, device=dev)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layers.append(LlamaLayerParams(
            input_norm=_tensor(sd(p + "input_layernorm.weight"), dev,
                               torch.bfloat16),
            wqkv=fuse_linears([lin(p + "self_attn.q_proj.weight"),
                               lin(p + "self_attn.k_proj.weight"),
                               lin(p + "self_attn.v_proj.weight")]),
            wo=lin(p + "self_attn.o_proj.weight"),
            post_norm=_tensor(sd(p + "post_attention_layernorm.weight"), dev,
                              torch.bfloat16),
            wgate_up=fuse_linears([lin(p + "mlp.gate_proj.weight"),
                                   lin(p + "mlp.up_proj.weight")]),
            down=lin(p + "mlp.down_proj.weight")))
        gc.collect()
    stacked = stack_layers(layers)
    del layers

    cos, sin = opsref.make_rope_cache(cfg.head_dim, max(cfg.max_sqlen, 8192),
                                      cfg.rope_theta, device=dev)
    try:
        lm_head_w = sd("lm_head.weight")
    except KeyError:  # tied embeddings
        lm_head_w = sd("model.embed_tokens.weight")
    return LlamaParams(
        embed=_tensor(sd("model.embed_tokens.weight"), dev, torch.bfloat16),
        layers=stacked,
        final_norm=_tensor(sd("model.norm.weight"), dev, torch.bfloat16),
        lm_head=quantize_linear(_padded_head(lm_head_w), qcfg, device=dev),
        rope_cos=cos, rope_sin=sin)


# ---------------------------------------------------------------------------
# Reference exported-.bin source (llm/tools/llama_exporter.py layout)
# ---------------------------------------------------------------------------

REF_INT4_GROUP = 32  # the reference's CPU QK (llm/include/common.h:17-21)


def read_reference_int4(qdir, oc: int, ic: int, layout: str = "QM_x86"):
    """Read ONE reference-quantized linear dir (model_quantizer.py output:
    weight_int4.bin + scaling_factor_int4.bin + offset_int4.bin +
    zero_point_int4.bin, llm/tools/model_quantizer.py:35-66) and return
    either

      ("codes", codes [OC, IC] uint8 in [0,15], scales [OC, IC//32] f32)
        — the no-offset case (zero_point == 8, offsets == 0): importable
        bit-exactly (the stored codes/scales are what the quantizer would
        produce, quant/numerics.py);
      ("fp", w [OC, IC] f32, None)
        — non-trivial offsets/zero-point: the weight is dequantized with
        the reference's with-offset semantics ``w = (q - zp)*d + m``
        (kernels/matmul_int4.cc:133-166) for requantization downstream,
        with a warning.

    Supported layouts: QM_x86 (q4_3, quantize_methods.py:188-242) and
    QM_ARM (q4_4, :245-296); both flatten [OC, IC] row-major into
    32-element blocks. QM_CUDA (int32/fp16 containers) is rejected."""
    qdir = Path(qdir)
    if layout not in ("QM_x86", "QM_ARM"):
        raise ValueError(
            f"unsupported reference int4 layout {layout!r}: QM_CUDA stores "
            "int32-packed weights + fp16 scales (quantize_methods.py q4_6) "
            "— re-export with QM_x86 or QM_ARM, or import the FP32 tree")
    nb = oc * ic // REF_INT4_GROUP
    qs = np.fromfile(qdir / "weight_int4.bin", np.uint8)
    d = np.fromfile(qdir / "scaling_factor_int4.bin", np.float32)
    if qs.size != oc * ic // 2 or d.size != nb:
        raise ValueError(
            f"{qdir}: weight_int4/scaling_factor sizes {qs.size}/{d.size} "
            f"don't match [{oc}, {ic}] at group {REF_INT4_GROUP} f32 scales "
            "(fp16-scale exports are not supported)")
    m_path, zp_path = qdir / "offset_int4.bin", qdir / "zero_point_int4.bin"
    m = np.fromfile(m_path, np.float32) if m_path.exists() else np.zeros(0)
    zp = (np.fromfile(zp_path, np.float32) if zp_path.exists()
          else np.full(1, 8.0, np.float32))

    codes = np.empty((nb, REF_INT4_GROUP), np.uint8)
    if layout == "QM_x86":   # byte e of block-pair p: (x[2p, e], x[2p+1, e])
        pairs = qs.reshape(nb // 2, REF_INT4_GROUP)
        codes[0::2] = pairs & 0x0F
        codes[1::2] = pairs >> 4
    else:                     # QM_ARM: byte e of block b: (x[b,e], x[b,16+e])
        half = qs.reshape(nb, REF_INT4_GROUP // 2)
        codes[:, :16] = half & 0x0F
        codes[:, 16:] = half >> 4
    codes = codes.reshape(oc, ic)
    scales = d.reshape(oc, ic // REF_INT4_GROUP)

    zp_ok = zp.size > 0 and np.all(zp == 8.0)
    off_ok = m.size == 0 or not np.any(m)
    if zp_ok and off_ok:
        return "codes", codes, scales
    # apply the offsets: exact with-offset dequant, then requantize
    z = float(zp.reshape(-1)[0]) if zp.size else 8.0
    off = (m.reshape(oc, ic // REF_INT4_GROUP) if m.size == nb
           else np.zeros((oc, ic // REF_INT4_GROUP), np.float32))
    w = ((codes.astype(np.float32).reshape(oc, -1, REF_INT4_GROUP) - z)
         * scales[..., None] + off[..., None]).reshape(oc, ic)
    warnings.warn(
        f"{qdir}: non-trivial zero_point/offset — dequantized with the "
        "reference's with-offset semantics and REQUANTIZED (not bit-exact "
        "to the source export)", stacklevel=2)
    return "fp", w, None


def _codes_linear(codes, scales, qcfg: QuantConfig, dev):
    """Stored reference codes and scales (group 32) → QM_TPU int4."""
    return int4_linear_from_codes(codes, scales, REF_INT4_GROUP,
                                  qcfg.scale_dtype, a8=qcfg.scheme == "w4a8",
                                  device=dev)


def _ref_int4_linear(qdir, oc: int, ic: int, layout: str, qcfg: QuantConfig,
                     device=None):
    """Reference-quantized dir → Int4Linear/Int4A8Linear. The no-offset case
    repacks the STORED codes/scales (group 32) into QM_TPU bit-exactly; the
    offset case requantizes the dequantized fp weight under ``qcfg``."""
    dev = resolve_device(device)
    kind, a, scales = read_reference_int4(qdir, oc, ic, layout)
    if kind == "fp":
        return quantize_linear(a, qcfg, device=dev)
    return _codes_linear(a, scales, qcfg, dev)


def convert_reference_llama(src: str, cfg: ModelConfig, qcfg: QuantConfig,
                            tp_degree: int = 1, ref_layout: str = "QM_x86",
                            device=None) -> LlamaParams:
    """TinyChatEngine FP32 *or quantized* export dir → LlamaParams.

    FP32 layout (llama_exporter.py:18-98): lm_head.bin,
    decoder/embed_tokens/weight.bin, decoder/norm/weight.bin,
    decoder/layer{i}/{q,k,v,o}_proj|gate_proj|up_proj|down_proj/weight.bin,
    decoder/layer{i}/{input,post_attention}_layernorm/weight.bin,
    decoder/layer{i}/rotary_emb/{cos,sin}_cached.bin.

    Quantized layout (model_quantizer.py output — detected by
    weight_int4.bin under the linears): same tree, each linear dir holding
    weight_int4/scaling_factor_int4/offset_int4/zero_point_int4.bin; norms
    and embeddings are copied verbatim by the quantizer. No-offset exports
    (the quantizer's own output: zp=8, offsets=0) import bit-exactly;
    offset-bearing ones are dequantized+requantized with a warning
    (read_reference_int4). ``ref_layout`` names the source QM packing."""
    _single_device(tp_degree)
    dev = resolve_device(device)
    root = Path(src)
    is_int4 = (root / "decoder/layer0/self_attn/q_proj/weight_int4.bin"
               ).exists()

    def raw(rel, shape):
        # threaded C++ pread when built (native/src/loader.cc, the analog of
        # the reference's read_to_array, llm/src/utils.cc); else np.fromfile
        return native.read_file(str(root / rel), np.float32).reshape(shape)

    def lin(rel, oc, ic):
        if is_int4:
            if qcfg.scheme not in ("w4a16", "w4a8"):
                raise ValueError(
                    f"a reference INT4 export can only convert to "
                    f"w4a16/w4a8, not {qcfg.scheme!r}")
            return _ref_int4_linear(root / rel, oc, ic, ref_layout, qcfg, dev)
        return quantize_linear(raw(f"{rel}/weight.bin", (oc, ic)), qcfg,
                               device=dev)

    e, f, v = cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size
    kvdim = cfg.num_kv_heads * cfg.head_dim

    def norm(rel):
        return _tensor(raw(rel, (e,)), dev, torch.bfloat16)

    layers = []
    for i in range(cfg.num_layers):
        d = f"decoder/layer{i}"
        layers.append(LlamaLayerParams(
            input_norm=norm(f"{d}/input_layernorm/weight.bin"),
            wqkv=fuse_linears(
                [lin(f"{d}/self_attn/q_proj", e, e),
                 lin(f"{d}/self_attn/k_proj", kvdim, e),
                 lin(f"{d}/self_attn/v_proj", kvdim, e)]),
            wo=lin(f"{d}/self_attn/o_proj", e, e),
            post_norm=norm(f"{d}/post_attention_layernorm/weight.bin"),
            wgate_up=fuse_linears(
                [lin(f"{d}/mlp/gate_proj", f, e),
                 lin(f"{d}/mlp/up_proj", f, e)]),
            down=lin(f"{d}/mlp/down_proj", e, f)))
    stacked = stack_layers(layers)

    # rotary caches: prefer the exporter's own (rotary_emb_exporter.py), else
    # regenerate from config
    rope_dir = root / "decoder/layer0/self_attn/rotary_emb"
    if (rope_dir / "cos_cached.bin").exists():
        cos_raw = np.fromfile(rope_dir / "cos_cached.bin", np.float32)
        n_pos = cos_raw.size // cfg.head_dim
        cos = _tensor(cos_raw.reshape(n_pos, cfg.head_dim), dev)
        sin = _tensor(np.fromfile(rope_dir / "sin_cached.bin", np.float32)
                      .reshape(n_pos, cfg.head_dim), dev)
    else:
        cos, sin = opsref.make_rope_cache(cfg.head_dim, cfg.max_sqlen,
                                          cfg.rope_theta, device=dev)

    pad = llama.lmhead_padded(v) - v
    if is_int4:
        # quantized exports hold lm_head under lm_head/weight_int4.bin
        # (model_quantizer.py:51-52); pad the OC axis to the lane multiple
        # with zero-point codes (dequant == 0 exactly)
        kind, a, scales = read_reference_int4(root / "lm_head", v, e,
                                              ref_layout)
        if kind == "codes":
            a = np.concatenate(
                [a, np.full((pad, e), ZERO_POINT_CODE, a.dtype)])
            scales = np.concatenate(
                [scales, np.zeros((pad, scales.shape[1]), scales.dtype)])
            lm_head = _codes_linear(a, scales, qcfg, dev)
        else:
            lm_head = quantize_linear(
                np.concatenate([a, np.zeros((pad, e), np.float32)]), qcfg,
                device=dev)
    else:
        lm_head = quantize_linear(
            np.concatenate([raw("lm_head.bin", (v, e)),
                            np.zeros((pad, e), np.float32)]), qcfg,
            device=dev)
    return LlamaParams(
        embed=_tensor(raw("decoder/embed_tokens/weight.bin", (v, e)), dev,
                      torch.bfloat16),
        layers=stacked,
        final_norm=norm("decoder/norm/weight.bin"),
        lm_head=lm_head,
        rope_cos=cos, rope_sin=sin)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _load_awq_calib(path: str, src: str, cfg, n_windows: int,
                    window: int = 512):
    """Calibration token windows [n, window] from a .npy id file or a text
    file tokenized with the source checkpoint's tokenizer."""
    p = Path(path)
    if p.suffix == ".npy":
        ids = np.load(p).reshape(-1).astype(np.int32)
    else:
        from tinychatengine_tpu_torch.tools.checkpoint import load_tokenizer
        tok = load_tokenizer(src, cfg)
        ids = np.asarray(tok.encode(p.read_text(encoding="utf-8")), np.int32)
    n = min(n_windows, max(len(ids) // window, 1))
    usable = ids[:n * window]
    if len(usable) < n * window:  # short file: pad by wrapping
        usable = np.resize(ids, n * window)
    return usable.reshape(n, window)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="convert a Hugging Face checkpoint or a reference export "
                    "to a tinychatengine_tpu.v1 checkpoint")
    ap.add_argument("--model", required=True)
    ap.add_argument("--src", required=True,
                    help="HF dir or reference .bin export dir")
    ap.add_argument("--out", required=True)
    ap.add_argument("--scheme", default="w4a16",
                    choices=["w4a16", "w4a8", "w8a8", "fp"])
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--ref-layout", default="QM_x86",
                    choices=["QM_x86", "QM_ARM"],
                    help="nibble packing of a reference INT4 export dir "
                         "(model_quantizer.py --method); auto-detected "
                         "trees with weight_int4.bin import through "
                         "read_reference_int4")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree of the fused qkv/gate-up "
                         "column layout (llama family); the port builds 1 "
                         "only")
    ap.add_argument("--vlm", action="store_true",
                    help="also convert the CLIP vision tower + mm_projector "
                         "from the same checkpoint (LLaVA/VILA)")
    ap.add_argument("--awq-calib", default=None,
                    help="calibration file for AWQ activation-aware scale "
                         "search before int4 quantization (quant/awq.py): "
                         "a .npy of token ids or a text file tokenized with "
                         "the source tokenizer. llama family, HF source, "
                         "w4a16/w4a8, --tp 1 only")
    ap.add_argument("--awq-windows", type=int, default=16,
                    help="number of 512-token calibration windows")
    ap.add_argument("--device", default="cuda",
                    help="where the tree is built and the AWQ calibration "
                         "runs: cuda (the card) or cpu")
    return ap


def main(argv=None):
    from tinychatengine_tpu_torch.tools.checkpoint import (save_checkpoint,
                                                           save_clip)

    ap = build_parser()
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_model_config(args.model)
    qcfg = QuantConfig(scheme=args.scheme, group_size=args.group_size)
    src = Path(args.src)
    is_ref = (src / "decoder").exists()
    if args.awq_calib and (cfg.family != "llama" or is_ref or args.tp != 1
                           or args.scheme not in ("w4a16", "w4a8")):
        ap.error("--awq-calib: llama family, HF source, w4a16/w4a8, --tp 1")
    if cfg.family == "llama":
        if args.awq_calib:
            from tinychatengine_tpu_torch.quant.awq import awq_scale_llama
            fp_params = convert_hf_llama(
                args.src, cfg, QuantConfig(scheme="fp"), 1, device=dev)
            calib = _load_awq_calib(args.awq_calib, args.src, cfg,
                                    args.awq_windows)
            scaled, info = awq_scale_llama(fp_params, cfg, calib,
                                           args.group_size)
            del fp_params
            gc.collect()
            print(f"awq alphas: { {k: v for k, v in info['alpha'].items()} }")
            params = requantize_llama(scaled, qcfg)
        else:
            params = (convert_reference_llama(args.src, cfg, qcfg, args.tp,
                                              ref_layout=args.ref_layout,
                                              device=dev)
                      if is_ref
                      else convert_hf_llama(args.src, cfg, qcfg, args.tp,
                                            device=dev))
    elif cfg.family == "opt":
        if is_ref:
            params = convert_reference_opt(args.src, cfg,
                                           int8=(args.scheme == "w8a8"),
                                           device=dev)
        else:
            if args.scheme == "w8a8":
                ap.error("HF OPT → W8A8 requires activation calibration: "
                         "convert with --scheme fp, then run "
                         "tools.calibrate_opt (or import the reference's "
                         "SmoothQuant export directory)")
            params = convert_hf_opt(args.src, cfg, qcfg, device=dev)
    elif cfg.family == "gptbigcode":
        params = (convert_reference_gptbigcode(args.src, cfg, qcfg, device=dev)
                  if is_ref else convert_hf_gptbigcode(args.src, cfg, qcfg,
                                                       device=dev))
    elif cfg.family == "clip":
        clip_params = (convert_reference_clip(args.src, cfg, device=dev)
                       if (src / "encoder").exists()
                       else convert_hf_clip(args.src, cfg, device=dev))
        save_clip(args.out, clip_params, cfg)
        print(f"converted {args.model} (fp vision tower) -> {args.out}/clip")
        return
    else:
        raise NotImplementedError(cfg.family)
    save_checkpoint(args.out, params, cfg, qcfg,
                    extra_meta={"family": cfg.family, "tp_degree": args.tp})
    if args.vlm:
        import dataclasses as _dc
        clip_cfg = get_model_config("clip_vit_large")
        clip_cfg = _dc.replace(clip_cfg, mmproj_dim=cfg.embed_dim)
        clip_params = convert_hf_clip(
            args.src, clip_cfg, mm_proj_src=args.src,
            prefix="model.vision_tower.vision_tower.vision_model.", device=dev)
        save_clip(args.out, clip_params, clip_cfg)
        print("vision tower + mm_projector saved")
    print(f"converted {args.model} ({args.scheme}, g={args.group_size}) -> "
          f"{args.out}")


# ---------------------------------------------------------------------------
# OPT (fp from HF; SmoothQuant W8A8 from the reference INT8 export)
# ---------------------------------------------------------------------------

def convert_hf_opt(src: str, cfg: ModelConfig, qcfg: QuantConfig,
                   device=None) -> opt.OPTParams:
    """HF OPTForCausalLM → OPTParams on ``device``.

    fp → f32 DenseLinear; w4a16/w4a8 → Int4(A8)Linear with an f32 bias on
    every projection (the reference's Int4OPT* stack) and on the tied head,
    padded to a tile-friendly N. W8A8 needs activation calibration:
    tools.calibrate_opt, or the reference's SmoothQuant export via
    convert_reference_opt."""
    if qcfg.scheme not in ("fp", "w4a16", "w4a8"):
        raise ValueError(
            "HF OPT converts to fp/w4a16/w4a8; W8A8 requires calibration — "
            "use tools.calibrate_opt on an fp checkpoint, or import the "
            "reference's SmoothQuant export (convert_reference_opt)")
    dev = resolve_device(device)
    sd = _hf_state_dict_loader(src)

    def lin(name):
        w = sd(name + ".weight")  # [OC, IC]
        bias = sd(name + ".bias")
        if qcfg.scheme == "fp":
            return DenseLinear(weight=_kmajor(w, dev), bias=_tensor(bias, dev))
        return quantize_linear(w, qcfg, bias=bias, device=dev)

    def f32(name):
        return _tensor(sd(name), dev)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.decoder.layers.{i}."
        layers.append(opt.OPTLayerParams(
            attn_ln_w=f32(p + "self_attn_layer_norm.weight"),
            attn_ln_b=f32(p + "self_attn_layer_norm.bias"),
            q_proj=lin(p + "self_attn.q_proj"),
            k_proj=lin(p + "self_attn.k_proj"),
            v_proj=lin(p + "self_attn.v_proj"),
            out_proj=lin(p + "self_attn.out_proj"),
            final_ln_w=f32(p + "final_layer_norm.weight"),
            final_ln_b=f32(p + "final_layer_norm.bias"),
            fc1=lin(p + "fc1"), fc2=lin(p + "fc2")))
        gc.collect()
    stacked = stack_layers(layers)
    embed_np = sd("model.decoder.embed_tokens.weight")
    embed = _tensor(embed_np, dev)
    if qcfg.scheme == "fp":
        lm_head = DenseLinear(weight=embed.to(torch.bfloat16).T.contiguous())
    else:  # quantize the tied head too; pad N to a tile-friendly width
        lm_head = quantize_linear(_padded_head(embed_np), qcfg, device=dev)
    return opt.OPTParams(
        embed_tokens=embed,
        embed_positions=f32("model.decoder.embed_positions.weight"),
        layers=stacked,
        final_ln_w=f32("model.decoder.final_layer_norm.weight"),
        final_ln_b=f32("model.decoder.final_layer_norm.bias"),
        lm_head=lm_head)


def convert_reference_opt(src: str, cfg: ModelConfig, int8: bool = True,
                          device=None) -> opt.OPTParams:
    """TinyChatEngine OPT export dir → OPTParams on ``device``.

    INT8 layout (llm/tools/opt_smooth_exporter.py:29-80 _export_Qmodel):
    lm_head.bin; decoder/{embed_tokens,embed_positions,final_layer_norm}/;
    decoder/layer{i}/self_attn/{q,k,v}_proj/{weight,bias_int8,alpha,beta}.bin,
    out_proj/{weight,bias,alpha}.bin, qk_bmm/alpha.bin, pv_bmm/alpha.bin;
    layer{i}/{self_attn_layer_norm,final_layer_norm}/{weight,bias}.bin;
    fc1 (W8A8B8O8+ReLU), fc2 (W8A8BFP32OFP32).
    The s8-domain bias (bias_int8 x beta) is pre-folded to fp32 here
    (kernels/ref/matmul_ref_int8.cc:28-31 semantics).
    """
    dev = resolve_device(device)
    root = Path(src)
    e, f, v = cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size

    def raw(rel, dtype, shape):
        return native.read_file(str(root / rel), dtype).reshape(shape)

    def scalar(rel):
        return torch.tensor(float(raw(rel, np.float32, (1,))[0]),
                            dtype=torch.float32, device=dev)

    def w8(prefix, k, n):  # the int8 [N, K] file as the [K, N] weight
        return torch.from_numpy(raw(f"{prefix}/weight.bin", np.int8,
                                    (n, k))).to(dev).T

    def w8_s8out(prefix, k, n):  # W8A8B8O8Linear: s8 bias folded via beta
        beta = float(raw(f"{prefix}/beta.bin", np.float32, (1,))[0])
        bias8 = raw(f"{prefix}/bias_int8.bin", np.int8, (n,)).astype(np.float32)
        return W8A8Linear(weight=w8(prefix, k, n),
                          alpha=scalar(f"{prefix}/alpha.bin"),
                          bias=_tensor(bias8 * beta, dev))

    def w8_f32out(prefix, k, n):  # W8A8BFP32OFP32Linear
        return W8A8Linear(
            weight=w8(prefix, k, n), alpha=scalar(f"{prefix}/alpha.bin"),
            bias=_tensor(raw(f"{prefix}/bias.bin", np.float32, (n,)), dev))

    def dense(prefix, k, n):
        return DenseLinear(
            weight=_kmajor(raw(f"{prefix}/weight.bin", np.float32, (n, k)),
                           dev),
            bias=_tensor(raw(f"{prefix}/bias.bin", np.float32, (n,)), dev))

    def ln(p, n=e):
        return (_tensor(raw(f"{p}/weight.bin", np.float32, (n,)), dev),
                _tensor(raw(f"{p}/bias.bin", np.float32, (n,)), dev))

    layers = []
    for i in range(cfg.num_layers):
        d = f"decoder/layer{i}"
        a = f"{d}/self_attn"
        ln1w, ln1b = ln(f"{d}/self_attn_layer_norm")
        ln2w, ln2b = ln(f"{d}/final_layer_norm")
        if int8:
            layers.append(opt.OPTLayerParams(
                attn_ln_w=ln1w, attn_ln_b=ln1b,
                q_proj=w8_s8out(f"{a}/q_proj", e, e),
                k_proj=w8_s8out(f"{a}/k_proj", e, e),
                v_proj=w8_s8out(f"{a}/v_proj", e, e),
                out_proj=w8_f32out(f"{a}/out_proj", e, e),
                final_ln_w=ln2w, final_ln_b=ln2b,
                fc1=w8_s8out(f"{d}/fc1", e, f),
                fc2=w8_f32out(f"{d}/fc2", f, e),
                qk_alpha=scalar(f"{a}/qk_bmm/alpha.bin"),
                pv_alpha=scalar(f"{a}/pv_bmm/alpha.bin")))
        else:
            layers.append(opt.OPTLayerParams(
                attn_ln_w=ln1w, attn_ln_b=ln1b,
                q_proj=dense(f"{a}/q_proj", e, e),
                k_proj=dense(f"{a}/k_proj", e, e),
                v_proj=dense(f"{a}/v_proj", e, e),
                out_proj=dense(f"{a}/out_proj", e, e),
                final_ln_w=ln2w, final_ln_b=ln2b,
                fc1=dense(f"{d}/fc1", e, f), fc2=dense(f"{d}/fc2", f, e)))
    stacked = stack_layers(layers)

    lnf_w, lnf_b = ln("decoder/final_layer_norm")
    return opt.OPTParams(
        embed_tokens=_tensor(raw("decoder/embed_tokens/weight.bin",
                                 np.float32, (v, e)), dev),
        embed_positions=_tensor(raw("decoder/embed_positions/weight.bin",
                                    np.float32, (-1, e)), dev),
        layers=stacked,
        final_ln_w=lnf_w, final_ln_b=lnf_b,
        lm_head=DenseLinear(weight=_kmajor(
            raw("lm_head.bin", np.float32, (v, e)), dev, torch.bfloat16)))


# ---------------------------------------------------------------------------
# GPTBigCode / StarCoder
# ---------------------------------------------------------------------------

def convert_hf_gptbigcode(src: str, cfg: ModelConfig, qcfg: QuantConfig,
                          device=None) -> gptbigcode.GPTBigCodeParams:
    """HF GPTBigCodeForCausalLM → GPTBigCodeParams on ``device`` (c_attn
    already fused [q | kv] in HF; the linears quantized with their biases,
    norms bf16)."""
    dev = resolve_device(device)
    sd = _hf_state_dict_loader(src)

    def lin(name):
        return quantize_linear(sd(name + ".weight"), qcfg,
                               bias=sd(name + ".bias"), device=dev)

    def bf16(name):
        return _tensor(sd(name), dev, torch.bfloat16)

    layers = []
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        layers.append(gptbigcode.GPTBigCodeLayerParams(
            ln1_w=bf16(p + "ln_1.weight"), ln1_b=bf16(p + "ln_1.bias"),
            c_attn=lin(p + "attn.c_attn"), c_proj=lin(p + "attn.c_proj"),
            ln2_w=bf16(p + "ln_2.weight"), ln2_b=bf16(p + "ln_2.bias"),
            fc_in=lin(p + "mlp.c_fc"), fc_out=lin(p + "mlp.c_proj")))
        gc.collect()
    stacked = stack_layers(layers)
    wte_f32 = sd("transformer.wte.weight")
    return gptbigcode.GPTBigCodeParams(
        wte=_tensor(wte_f32, dev, torch.bfloat16),
        wpe=bf16("transformer.wpe.weight"),
        layers=stacked,
        lnf_w=bf16("transformer.ln_f.weight"),
        lnf_b=bf16("transformer.ln_f.bias"),
        # tied head quantized from the RAW f32 embedding (not the bf16-
        # rounded wte), as the reference export writes lm_head.bin in f32
        # (starcoder_exporter.py:28-30)
        lm_head=quantize_linear(wte_f32, qcfg, device=dev))


def convert_reference_gptbigcode(src: str, cfg: ModelConfig,
                                 qcfg: QuantConfig, device=None
                                 ) -> gptbigcode.GPTBigCodeParams:
    """TinyChatEngine StarCoder FP32 export dir → GPTBigCodeParams.

    Layout (starcoder_exporter.py:25-127): ``lm_head.bin``,
    ``decoder/{wte,wpe}/weight.bin``, ``decoder/ln_f/{weight,bias}.bin``,
    ``decoder/layer{i}/{attn/{c_attn,c_proj}, ln_1, ln_2, c_fc, c_proj}``.
    The exporter expands MQA to MHA (``_export_LinearFP_MQAtoMHA`` tiles the
    single K/V head across all heads); only the FIRST replica is read back,
    restoring the single-KV-head layout the multi-query attention streams.
    """
    dev = resolve_device(device)
    root = Path(src)
    e = cfg.embed_dim
    h, d = cfg.num_heads, cfg.head_dim

    def raw(rel, shape):
        return native.read_file(str(root / rel), np.float32).reshape(shape)

    def lin(rel, k, n):
        return quantize_linear(raw(f"{rel}/weight.bin", (n, k)), qcfg,
                               bias=raw(f"{rel}/bias.bin", (n,)), device=dev)

    def c_attn(rel):
        w = raw(f"{rel}/weight.bin", (3 * h * d, e))
        b = raw(f"{rel}/bias.bin", (3 * h * d,))
        # un-tile: [q(0:hd) | k tiled h x d | v tiled h x d] → [q | k1 | v1]
        w = np.concatenate([w[:h * d], w[h * d:h * d + d],
                            w[2 * h * d:2 * h * d + d]])
        b = np.concatenate([b[:h * d], b[h * d:h * d + d],
                            b[2 * h * d:2 * h * d + d]])
        return quantize_linear(w, qcfg, bias=b, device=dev)

    def bf16(rel, shape=(e,)):
        return _tensor(raw(rel, shape), dev, torch.bfloat16)

    layers = []
    for i in range(cfg.num_layers):
        p = f"decoder/layer{i}"
        layers.append(gptbigcode.GPTBigCodeLayerParams(
            ln1_w=bf16(f"{p}/ln_1/weight.bin"),
            ln1_b=bf16(f"{p}/ln_1/bias.bin"),
            c_attn=c_attn(f"{p}/attn/c_attn"),
            c_proj=lin(f"{p}/attn/c_proj", e, e),
            ln2_w=bf16(f"{p}/ln_2/weight.bin"),
            ln2_b=bf16(f"{p}/ln_2/bias.bin"),
            fc_in=lin(f"{p}/c_fc", e, cfg.hidden_dim),
            fc_out=lin(f"{p}/c_proj", cfg.hidden_dim, e)))
        gc.collect()
    stacked = stack_layers(layers)

    return gptbigcode.GPTBigCodeParams(
        wte=bf16("decoder/wte/weight.bin", (cfg.vocab_size, e)),
        wpe=bf16("decoder/wpe/weight.bin", (-1, e)),
        layers=stacked,
        lnf_w=bf16("decoder/ln_f/weight.bin"),
        lnf_b=bf16("decoder/ln_f/bias.bin"),
        lm_head=quantize_linear(raw("lm_head.bin", (cfg.vocab_size, e)),
                                qcfg, device=dev))


# ---------------------------------------------------------------------------
# CLIP vision tower (+ LLaVA mm_projector) — the VLM checkpoint prep
# ---------------------------------------------------------------------------

def _identity_projection(e: int, dev):
    eye = torch.eye(e, dtype=torch.float32, device=dev)
    return DenseLinear(weight=eye), DenseLinear(weight=eye.clone())


def convert_hf_clip(src: str, cfg: ModelConfig, mm_proj_src: str | None = None,
                    prefix: str = "vision_model.", device=None
                    ) -> clip.CLIPParams:
    """HF CLIPVisionModel (or the vision tower inside a LLaVA checkpoint,
    prefix "model.vision_tower.vision_tower.vision_model.") → CLIPParams
    (f32) on ``device``.

    mm_proj_src: checkpoint dir holding the LLaVA mm_projector weights
    (keys model.mm_projector.{0,2}.{weight,bias}); identity projection when
    absent (pure vision-tower use/testing)."""
    dev = resolve_device(device)
    sd = _hf_state_dict_loader(src)
    e, p = cfg.embed_dim, cfg.patch_size

    def dense(name, get=sd):
        return DenseLinear(weight=_kmajor(get(name + ".weight"), dev),
                           bias=_tensor(get(name + ".bias"), dev))

    def f32(name):
        return _tensor(sd(name), dev)

    layers = []
    for i in range(cfg.num_layers):
        q = f"{prefix}encoder.layers.{i}."
        layers.append(clip.CLIPLayerParams(
            ln1_w=f32(q + "layer_norm1.weight"),
            ln1_b=f32(q + "layer_norm1.bias"),
            q_proj=dense(q + "self_attn.q_proj"),
            k_proj=dense(q + "self_attn.k_proj"),
            v_proj=dense(q + "self_attn.v_proj"),
            out_proj=dense(q + "self_attn.out_proj"),
            ln2_w=f32(q + "layer_norm2.weight"),
            ln2_b=f32(q + "layer_norm2.bias"),
            fc1=dense(q + "mlp.fc1"), fc2=dense(q + "mlp.fc2")))
    stacked = stack_layers(layers)

    # conv kernel [E, 3, p, p] → patchify-matmul weight [(p,p,3) flat, E]
    conv = sd(prefix + "embeddings.patch_embedding.weight")
    patch_w = np.ascontiguousarray(conv.transpose(2, 3, 1, 0)).reshape(
        p * p * 3, e)

    if mm_proj_src is not None:
        mm_sd = _hf_state_dict_loader(mm_proj_src)
        mm0 = dense("model.mm_projector.0", mm_sd)
        mm2 = dense("model.mm_projector.2", mm_sd)
    else:  # identity projection (tower-only use)
        mm0, mm2 = _identity_projection(e, dev)

    return clip.CLIPParams(
        patch_embed=_tensor(patch_w, dev),
        class_embed=f32(prefix + "embeddings.class_embedding"),
        pos_embed=f32(prefix + "embeddings.position_embedding.weight"),
        pre_ln_w=f32(prefix + "pre_layrnorm.weight"),
        pre_ln_b=f32(prefix + "pre_layrnorm.bias"),
        layers=stacked,
        mm_proj_0=mm0, mm_proj_2=mm2)


def convert_reference_clip(src: str, cfg: ModelConfig, device=None
                           ) -> clip.CLIPParams:
    """TinyChatEngine CLIP-ViT FP32 export dir → CLIPParams on ``device``.

    Layout (clip_exporter.py:20-127):
    ``embeddings/{class_embedding,patch_embedding,position_embedding}/weight.bin``
    (patch kernel pre-transposed to [E, p, p, 3] by the exporter),
    ``pre_layernorm/{weight,bias}.bin``,
    ``encoder/layer{i}/{self_attn/{q,k,v,out}_proj, layer_norm1, layer_norm2,
    mlp_fc1, mlp_fc2}/{weight,bias}.bin``, and — when the LLaVA/VILA exporter
    ran (llava_exporter.py:33-46) — sibling ``mm_projector_{0,2}/`` dirs.
    """
    dev = resolve_device(device)
    root = Path(src)
    e, p = cfg.embed_dim, cfg.patch_size
    f = cfg.hidden_dim

    def raw(rel, shape):
        return native.read_file(str(root / rel), np.float32).reshape(shape)

    def dense(rel, k, n):
        return DenseLinear(
            weight=_kmajor(raw(f"{rel}/weight.bin", (n, k)), dev),
            bias=_tensor(raw(f"{rel}/bias.bin", (n,)), dev))

    def vec(rel, shape=(e,)):
        return _tensor(raw(rel, shape), dev)

    layers = []
    for i in range(cfg.num_layers):
        q = f"encoder/layer{i}"
        layers.append(clip.CLIPLayerParams(
            ln1_w=vec(f"{q}/layer_norm1/weight.bin"),
            ln1_b=vec(f"{q}/layer_norm1/bias.bin"),
            q_proj=dense(f"{q}/self_attn/q_proj", e, e),
            k_proj=dense(f"{q}/self_attn/k_proj", e, e),
            v_proj=dense(f"{q}/self_attn/v_proj", e, e),
            out_proj=dense(f"{q}/self_attn/out_proj", e, e),
            ln2_w=vec(f"{q}/layer_norm2/weight.bin"),
            ln2_b=vec(f"{q}/layer_norm2/bias.bin"),
            fc1=dense(f"{q}/mlp_fc1", e, f),
            fc2=dense(f"{q}/mlp_fc2", f, e)))
    stacked = stack_layers(layers)

    # the exporter stores the conv kernel NHWC [E, p, p, 3]; the model runs
    # it as a patchify-matmul [(p·p·3), E] (models/clip.py patch path)
    patch_w = raw("embeddings/patch_embedding/weight.bin", (e, p * p * 3)).T

    if (root / "mm_projector_0").exists():
        mm0 = dense("mm_projector_0", e, cfg.mmproj_dim)
        mm2 = dense("mm_projector_2", cfg.mmproj_dim, cfg.mmproj_dim)
    else:
        mm0, mm2 = _identity_projection(e, dev)

    return clip.CLIPParams(
        patch_embed=_tensor(patch_w, dev),
        class_embed=vec("embeddings/class_embedding/weight.bin"),
        pos_embed=vec("embeddings/position_embedding/weight.bin", (-1, e)),
        pre_ln_w=vec("pre_layernorm/weight.bin"),
        pre_ln_b=vec("pre_layernorm/bias.bin"),
        layers=stacked,
        mm_proj_0=mm0, mm_proj_2=mm2)


if __name__ == "__main__":
    main()
