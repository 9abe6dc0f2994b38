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
"""

from __future__ import annotations

import numpy as np

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
