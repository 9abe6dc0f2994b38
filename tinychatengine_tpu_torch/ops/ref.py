"""Plain PyTorch reference ops (counterpart of the JAX package's ops/ref.py).

Same cast points as the JAX versions: fp32 islands for norms and RoPE,
results back in the input dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from tinychatengine_tpu_torch.quant.packing import PLANE

ZERO_POINT = 8


def xla_recip(c: float) -> float:
    """The factor jitted JAX multiplies by where its code divides by the
    constant ``c``: XLA's simplifier rewrites ``x / c`` as ``x * (f32(1) /
    f32(c))``. ``x * xla_recip(c)`` on an f32 tensor gives the jitted
    function's bits, on the CPU and on the card alike (``1.0 / c`` in
    Python is the f64 reciprocal of the f64 ``c``, another number)."""
    return float(np.float32(1) / np.float32(c))


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """QM_TPU packed weights [IC//2, OC] uint8 → int8 codes [IC, OC] in
    [0, 15] (K-major)."""
    icp, oc = packed.shape
    assert icp % PLANE == 0, f"packed K/2={icp} must be a multiple of {PLANE}"
    p = packed.reshape(icp // PLANE, PLANE, oc)
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    return torch.stack([lo, hi], dim=1).reshape(icp * 2, oc)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                    group_size: int, dtype=torch.bfloat16) -> torch.Tensor:
    """QM_TPU weights → [IC, OC] in ``dtype``: (q - 8) * d, computed in f32."""
    codes = unpack_int4(packed)
    ic, oc = codes.shape
    w = (codes - ZERO_POINT).to(torch.float32)
    w = (w.reshape(ic // group_size, group_size, oc)
         * scales[:, None, :].to(torch.float32))
    return w.reshape(ic, oc).to(dtype)


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """LlamaRMSNorm with fp32 accumulation."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with bias, fp32 statistics; result in x.dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def layer_norm_q_ref(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNormQ (SmoothQuant's static activation quantization, the scale
    folded into the LN weights): fp32 LN, round half to even, clip to
    int8."""
    y = layer_norm_ref(x.to(torch.float32), weight, bias, eps)
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def w8a8_linear_ref(x_q: torch.Tensor, w_q: torch.Tensor, alpha,
                    bias: torch.Tensor | None = None,
                    out_int8: bool = True) -> torch.Tensor:
    """SmoothQuant W8A8 linear oracle with the weight [N, K] (CPU): acc =
    x_q @ w_q^T exact in int64; y = acc * alpha (+ fp32 bias), clipped to
    int8 after round half to even when ``out_int8``."""
    acc = torch.einsum("...k,nk->...n", x_q.to(torch.int64),
                       w_q.to(torch.int64))
    y = acc.to(torch.float32) * alpha
    if bias is not None:
        y = y + bias.to(torch.float32)
    if out_int8:
        return torch.clamp(torch.round(y), -128, 127).to(torch.int8)
    return y


def apply_rotary(q: torch.Tensor, k: torch.Tensor, cos_sel: torch.Tensor,
                 sin_sel: torch.Tensor):
    """Rotate-half RoPE with pre-gathered cos/sin [B, S, D]."""
    c = cos_sel[:, :, None, :].to(torch.float32)
    s = sin_sel[:, :, None, :].to(torch.float32)

    def rot(x):
        xf = x.to(torch.float32)
        d = x.shape[-1]
        x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
        rotated = torch.cat([-x2, x1], dim=-1)
        return (xf * c + rotated * s).to(x.dtype)

    return rot(q), rot(k)


def make_rope_cache(head_dim: int, max_pos: int, theta: float = 10000.0,
                    device=None):
    """cos/sin tables [max_pos, head_dim] f32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def silu_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def gelu_ref(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (GPTBigCode's MLP), in x's dtype."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def quick_gelu_ref(x: torch.Tensor) -> torch.Tensor:
    """quick-GELU x * sigmoid(1.702 x) (CLIP's MLP), in x's dtype."""
    return x * torch.sigmoid(1.702 * x)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, group_size: int) -> torch.Tensor:
    """W4A16 linear oracle: y = x @ dequant(W) in f32 (pack-time K padding
    dropped), in x.dtype. x [..., IC]; packed [IC//2, OC] uint8; scales
    [IC//G, OC]."""
    w = dequantize_int4(packed, scales, group_size, dtype=torch.float32)
    w = w[:x.shape[-1]]
    return torch.einsum("...k,kn->...n", x.to(torch.float32), w).to(x.dtype)


def quantize_act_int8(x: torch.Tensor):
    """Dynamic per-tensor int8 activation quantization: scale =
    max(absmax / 127, 1e-8) (the division as jitted JAX runs it,
    ``xla_recip``), q = clip(round(x / scale)). Returns (int8 q, scale in
    x.dtype)."""
    scale = torch.clamp(x.abs().amax() * xla_recip(127.0), min=1e-8)
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale


def rotary_embed_ref(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, positions: torch.Tensor):
    """Rotate-half RoPE from the cos/sin tables [max_pos, D] at positions
    [B, S]; q [B, S, Hq, D], k [B, S, Hk, D] (GQA)."""
    return apply_rotary(q, k, cos[positions], sin[positions])


def softmax_ref(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax in f32, result in x.dtype."""
    xf = x.to(torch.float32)
    e = torch.exp(xf - xf.amax(dim=dim, keepdim=True))
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Dense masked attention oracle: q [B, Hq, Sq, D]; k/v [B, Hk, Sk, D]
    (GQA: Hq % Hk == 0, each KV head repeated for its query heads); mask
    additive, broadcastable to [B, 1, Sq, Sk]. f32 scores and PV, result
    in q.dtype."""
    hq, hk = q.shape[1], k.shape[1]
    if hk != hq:
        k = k.repeat_interleave(hq // hk, dim=1)
        v = v.repeat_interleave(hq // hk, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        logits = logits + mask.to(torch.float32)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return o.to(q.dtype)
