"""Typed model / quantization / generation configuration.

Replaces the reference's three config layers (SURVEY.md §5): the hard-coded
``model_config`` table (llm/include/model.h:5-83), the compile-time ``#define``
platform flags (llm/Makefile:29-130), and the runtime ``opt_params`` struct
(llm/include/Generate.h:48-72) — with plain dataclasses plus a registry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters for one model (reference: llm/include/model.h:5-83).

    Extends the reference struct with fields it hard-codes elsewhere:
    ``head_dim``, ``rope_theta`` (rotary_emb_exporter.py:77-81), activation
    type, and the architecture family tag used to pick the decoder.
    """

    name: str
    family: str  # "llama" | "opt" | "gptbigcode" | "clip"
    num_heads: int
    num_kv_heads: int
    num_layers: int
    max_sqlen: int
    embed_dim: int
    hidden_dim: int  # FFN intermediate size
    vocab_size: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # CLIP-only fields (model.h:17-20)
    image_size: int = 0
    patch_size: int = 0
    projection_dim: int = 0
    mmproj_dim: int = 0
    # TPU additions
    tie_word_embeddings: bool = False
    sliding_window: int | None = None  # Mistral attention window (the
    # reference ignores it — SURVEY.md §5 long-context audit)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def gqa_groups(self) -> int:
        return self.num_heads // self.num_kv_heads


def _llama(name, heads, kv_heads, layers, embed, hidden, vocab, eps,
           theta=10000.0, max_sqlen=2048, window=None):
    return ModelConfig(
        name=name, family="llama", num_heads=heads, num_kv_heads=kv_heads,
        num_layers=layers, max_sqlen=max_sqlen, embed_dim=embed,
        hidden_dim=hidden, vocab_size=vocab, rms_norm_eps=eps, rope_theta=theta,
        sliding_window=window,
    )


def _opt(name, heads, layers, embed, hidden, vocab=50272):
    return ModelConfig(
        name=name, family="opt", num_heads=heads, num_kv_heads=heads,
        num_layers=layers, max_sqlen=2048, embed_dim=embed, hidden_dim=hidden,
        vocab_size=vocab,
    )


# Registry mirroring llm/include/model.h:68-83 (+ rope thetas from
# llm/tools/rotary_emb_exporter.py and HF configs the exporters consume).
MODEL_REGISTRY: dict[str, ModelConfig] = {
    "opt_125m": _opt("opt_125m", 12, 12, 768, 3072),
    "opt_1.3b": _opt("opt_1.3b", 32, 24, 2048, 8192),
    "opt_6.7b": _opt("opt_6.7b", 32, 32, 4096, 16384),
    "llama_7b": _llama("llama_7b", 32, 32, 32, 4096, 11008, 32000, 1e-6),
    "llama_13b": _llama("llama_13b", 40, 40, 40, 5120, 13824, 32000, 1e-6),
    "llama2_7b": _llama("llama2_7b", 32, 32, 32, 4096, 11008, 32000, 1e-6),
    "llama2_13b": _llama("llama2_13b", 40, 40, 40, 5120, 13824, 32000, 1e-6),
    "codellama_7b": _llama("codellama_7b", 32, 32, 32, 4096, 11008, 32016, 1e-5, theta=1e6),
    "codellama_13b": _llama("codellama_13b", 40, 40, 40, 5120, 13824, 32016, 1e-5, theta=1e6),
    "llava_7b": _llama("llava_7b", 32, 32, 32, 4096, 11008, 32000, 1e-5),
    "llava_13b": _llama("llava_13b", 40, 40, 40, 5120, 13824, 32000, 1e-5),
    "vila_2.7b": _llama("vila_2.7b", 20, 20, 32, 2560, 6912, 32000, 1e-5),
    "vila_7b": _llama("vila_7b", 32, 32, 32, 4096, 11008, 32000, 1e-5),
    "vila_13b": _llama("vila_13b", 40, 40, 40, 5120, 13824, 32000, 1e-5),
    "mistral_7b": _llama("mistral_7b", 32, 8, 32, 4096, 14336, 32000, 1e-5,
                         theta=1e6, max_sqlen=8192, window=4096),
    "llama3_8b": _llama("llama3_8b", 32, 8, 32, 4096, 14336, 128256, 1e-5, theta=500000.0, max_sqlen=8192),
    # TPU-native addition (no reference counterpart): the in-repo accuracy
    # model — a byte-level LLaMA trained on local Python source by
    # tools/train_tiny.py. Zero-egress stand-in for the reference's
    # "download a real checkpoint" test pyramid (SURVEY.md §4/§6): real
    # (trained, not random) weights for end-to-end + perplexity regression.
    "bytellama_5m": _llama("bytellama_5m", 4, 2, 4, 256, 1024, 258, 1e-5,
                           max_sqlen=1024),
    # byte-level OPT analog of bytellama_5m: the trained real-weights anchor
    # for the SmoothQuant W8A8 Δppl row (native calibration via
    # tools/calibrate_opt.py — the reference imports pre-calibrated torch
    # weights instead, opt_smooth_exporter.py)
    "byteopt_4m": dataclasses.replace(
        _opt("byteopt_4m", 4, 4, 256, 1024, vocab=258), max_sqlen=1024),
    "starcoder_15.5b": ModelConfig(
        name="starcoder_15.5b", family="gptbigcode", num_heads=48, num_kv_heads=1,
        num_layers=40, max_sqlen=2048, embed_dim=6144, hidden_dim=24576,
        vocab_size=49152,
    ),
    # llava's/vila's CLIP uses 23 of 24 layers (model.h:81)
    "clip_vit_large": ModelConfig(
        name="clip_vit_large", family="clip", num_heads=16, num_kv_heads=16,
        num_layers=23, max_sqlen=2048, embed_dim=1024, hidden_dim=4096,
        vocab_size=0, image_size=336, patch_size=14, projection_dim=768,
        mmproj_dim=4096,
    ),
}


def get_model_config(name: str) -> ModelConfig:
    """Lookup mirroring get_opt_model_config (llm/include/model.h:85-144)."""
    key = name.lower()
    if key not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[key]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization scheme configuration.

    ``scheme``:
      - "fp"      : unquantized (bf16/fp32) — reference FP32 path.
      - "w4a8"    : same INT4 weights, activations dynamically quantized
                    to int8 per (row, group) at matmul time — the reference's
                    default x86/ARM path (USE_INT8_INT4_PRODUCT,
                    llm/src/ops/linear.cc:157-168)
      - "w4a16"   : AWQ group-wise INT4 weights, bf16 activations — the
                    TPU-native unification of the reference's W4A32/W4A16/W4A8
                    paths (llm/src/ops/linear.cc:171-236).
      - "w8a8"    : SmoothQuant static int8 (llm/src/ops/W8A8B8O8Linear.cc).

    INT4 numerics match llm/tools/quantize_methods.py:212-232 exactly:
    ``d = signed_absmax / -8``, ``q = clip(x/d + 8.5, 0, 15)`` (uint4,
    zero point 8); dequant ``(q - 8) * d``.
    """

    scheme: str = "w4a16"
    group_size: int = 128  # QK: 32 on CPU, 128 on CUDA (common.h:17-21); TPU default 128
    kv_cache_dtype: str = "bf16"  # "bf16" | "int8"
    act_dtype: str = "bf16"
    # Per-group scale storage. The reference stores fp16 scales (QM_* packers,
    # llm/tools/quantize_methods.py); bf16 is the TPU-native half format and
    # halves scale HBM traffic (~6% of decode weight bytes at group_size=128).
    # Scales are COMPUTED in f32 (numerics.py) and rounded once at pack time.
    # Default bf16: validated on-chip r3 (scripts/check_fused_correctness.py
    # ALL OK; scripts/ab_fused_decode.py 153.1 vs 149.2 tok/s over f32 —
    # loading a saved checkpoint keeps its stored dtype, so existing
    # f32-scale checkpoints are unaffected).
    scale_dtype: str = "bf16"  # "bf16" | "f32"

    def __post_init__(self):
        assert self.scheme in ("fp", "w4a16", "w4a8", "w8a8"), self.scheme
        assert self.group_size in (32, 64, 128, 256), self.group_size
        assert self.scale_dtype in ("bf16", "f32"), self.scale_dtype


@dataclasses.dataclass
class GenerationConfig:
    """Sampling/generation parameters (reference opt_params,
    llm/include/Generate.h:48-72, with the reference defaults)."""

    seed: int = -1
    n_predict: int = 128
    n_ctx: int = 512
    n_keep: int = 0
    top_k: int = 40          # <=0 → vocab size
    top_p: float = 0.95      # 1.0 = disabled
    tfs_z: float = 1.00      # 1.0 = disabled
    typical_p: float = 1.00  # 1.0 = disabled
    temp: float = 0.80       # <=0 → greedy
    repeat_penalty: float = 1.10
    repeat_last_n: int = 64  # 0 = disabled, -1 = context size
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    mirostat: int = 0        # 0 disabled, 1 v1, 2 v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    logit_bias: Optional[dict] = None
