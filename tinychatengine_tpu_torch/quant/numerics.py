"""Group-wise INT4 quantization numerics — exact reference parity.

Copy of the JAX package's quantizer (numpy only, so it runs where the port
runs). The quantization math shared by every QM_* packer of the reference
(llm/tools/quantize_methods.py:212-232):

    per group of ``group_size`` consecutive input-channel weights:
        max  = element with the largest |value| (signed!)
        d    = max / -8                      (scale)
        q    = clip(x / d + 8.5, 0, 15)      (uint4, implicit zero point 8)
    dequant:
        x'   = (q - 8) * d

The same int4 quantizer runs in torch for a weight that lies on the card
(``quantize_groupwise_int4_kn``), with numpy's bits.
"""

from __future__ import annotations

import numpy as np
import torch

ZERO_POINT = 8.0


def quantize_groupwise_int4(w: np.ndarray, group_size: int = 128):
    """Quantize ``w [OC, IC]`` (float) to uint4 codes + per-group scales.

    Returns:
      q:      uint8 [OC, IC]   values in [0, 15] (unpacked codes)
      scales: float32 [OC, IC // group_size]
    """
    w = np.asarray(w, dtype=np.float32)
    oc, ic = w.shape
    assert ic % group_size == 0, (ic, group_size)
    g = w.reshape(oc, ic // group_size, group_size)
    idx = np.argmax(np.abs(g), axis=-1)
    max_vals = np.take_along_axis(g, idx[..., None], axis=-1)[..., 0]
    d = max_vals / -8.0
    inv_d = np.where(d == 0.0, 0.0, np.divide(1.0, d, where=d != 0.0))
    q = np.clip(g * inv_d[..., None] + 8.5, 0.0, 15.0).astype(np.uint8)
    return q.reshape(oc, ic), d.astype(np.float32)


def dequantize_groupwise_int4(q: np.ndarray, scales: np.ndarray,
                              group_size: int = 128):
    """Inverse of quantize_groupwise_int4 (reference dequant semantics:
    kernels/matmul_int4.cc naive loops — ``(q - 8) * d``)."""
    oc, ic = q.shape
    g = q.reshape(oc, ic // group_size, group_size).astype(np.float32)
    return ((g - ZERO_POINT) * scales[..., None]).reshape(oc, ic).astype(
        np.float32)


def quantize_tensor_int8(x: np.ndarray):
    """Per-tensor symmetric int8 quantization (SmoothQuant static-scale
    export, llm/tools/opt_smooth_exporter.py): q = clip(round(x/s), -128,
    127), s = absmax / 127."""
    x = np.asarray(x, dtype=np.float32)
    s = float(np.max(np.abs(x))) / 127.0
    if s == 0.0:
        s = 1.0
    q = np.clip(np.round(x / s), -128, 127).astype(np.int8)
    return q, np.float32(s)


# ---- the int4 quantizer in torch, K-major --------------------------------
# quantize_groupwise_int4 on a [K, N] tensor on any device, groups along K
# (a column of the K-major weight is a row of numpy's [OC, IC]): the same
# operations in the same order, so the codes and scales are numpy's bit for
# bit. argmax takes the first maximal |value|; d = max / -8 and 1 / d are
# true divisions (numpy divides eagerly: no product by a reciprocal, which
# is what jitted XLA would run); g * inv_d and + 8.5 round separately, as
# two kernels (never one fused multiply-add); the cast to uint8 truncates.

def quantize_groupwise_int4_kn(w: torch.Tensor, group_size: int = 128):
    """w [K, N] float tensor → (codes uint8 [K, N] in [0, 15], scales f32
    [K // group_size, N]) on w's device: ``quantize_groupwise_int4(w.T)``
    transposed, bit for bit."""
    k, n = w.shape
    assert k % group_size == 0, (k, group_size)
    g = w.to(torch.float32).reshape(k // group_size, group_size, n)
    idx = torch.argmax(g.abs(), dim=1, keepdim=True)
    d = torch.gather(g, 1, idx) / -8.0  # -1/8 is exact: the same product
    inv_d = torch.where(d == 0.0, torch.zeros_like(d),
                        torch.div(torch.ones_like(d), d))
    q = torch.clamp(torch.add(torch.mul(g, inv_d), 8.5), 0.0, 15.0)
    return q.to(torch.uint8).reshape(k, n), d.reshape(k // group_size, n)


def dequantize_groupwise_int4_kn(q: torch.Tensor, scales: torch.Tensor,
                                 group_size: int = 128) -> torch.Tensor:
    """(q - 8) * d in f32 for codes [K, N] and scales [K // G, N]:
    ``dequantize_groupwise_int4`` transposed, bit for bit."""
    k, n = q.shape
    g = q.to(torch.float32).reshape(k // group_size, group_size, n)
    return ((g - ZERO_POINT) * scales[:, None, :]).reshape(k, n)


# ---- group-wise INT3 (the W3 experiment) ------------------------------------
# The int4 family at 3 bits: d = max / -4, q = clip(x / d + 4.5, 0, 7),
# dequant (q - 4) * d. Packed as two bitplanes by ops/int3_matmul.py.

ZERO_POINT3 = 4.0


def quantize_groupwise_int3(w: np.ndarray, group_size: int = 128):
    """w [OC, IC] float → uint8 codes in [0, 7] + per-group f32 scales
    [OC, IC // group_size]."""
    w = np.asarray(w, dtype=np.float32)
    oc, ic = w.shape
    assert ic % group_size == 0, (ic, group_size)
    g = w.reshape(oc, ic // group_size, group_size)
    idx = np.argmax(np.abs(g), axis=-1)
    max_vals = np.take_along_axis(g, idx[..., None], axis=-1)[..., 0]
    d = max_vals / -4.0
    inv_d = np.where(d == 0.0, 0.0, np.divide(1.0, d, where=d != 0.0))
    q = np.clip(g * inv_d[..., None] + 4.5, 0.0, 7.0).astype(np.uint8)
    return q.reshape(oc, ic), d.astype(np.float32)


def dequantize_groupwise_int3(q: np.ndarray, scales: np.ndarray,
                              group_size: int = 128):
    """(q - 4) * d, f32 [OC, IC]."""
    oc, ic = q.shape
    g = q.reshape(oc, ic // group_size, group_size).astype(np.float32)
    return ((g - ZERO_POINT3) * scales[..., None]).reshape(oc, ic) \
        .astype(np.float32)
