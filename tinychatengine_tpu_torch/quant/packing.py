"""QM_TPU: the packed INT4 weight layout, shared with the JAX package.

Copy of the JAX package's packer, with bf16 written through ``torch``
instead of ``ml_dtypes``. The layout is unchanged, so checkpoints are
interchangeable:

  * Weights are stored K-major: ``packed [IC//2, OC] uint8``.
  * Nibble pairing runs along IC in superblocks of 2*PLANE rows: within
    superblock ``s``, byte row ``i`` (0 <= i < PLANE) holds

        low  nibble = w[s*2*PLANE + i,         :]   (plane 0)
        high nibble = w[s*2*PLANE + PLANE + i, :]   (plane 1)

  * Per-group scales are stored ``[IC//group_size, OC]``.

bf16 arrays travel as their uint16 bit patterns in numpy (the checkpoint
format stores them so) and become ``torch.bfloat16`` tensors through
``from_bf16_bits``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PLANE = 128  # byte rows per nibble plane
SUPERBLOCK = 2 * PLANE
ZERO_POINT_CODE = 8  # dequantizes to exactly 0: (8 - 8) * d


def padded_ic(ic: int, group_size: int) -> int:
    """IC rounded up so a scale row count (IC/G) above 8 is a multiple of 8
    (the TPU kernels' sublane rule; kept so checkpoints stay shared). Padded
    K rows carry the zero-point code and span whole groups, so they
    contribute exactly 0 for zero-padded x."""
    sg = ic // group_size
    if sg <= 8 or sg % 8 == 0:
        return ic
    unit = math.lcm(8 * group_size, SUPERBLOCK)
    return -(-ic // unit) * unit


def to_bf16_bits(a) -> np.ndarray:
    """float array -> uint16 bf16 bit patterns (round to nearest even)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def from_bf16_bits(u16: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bit patterns -> ``torch.bfloat16`` tensor (CPU)."""
    a = np.ascontiguousarray(u16)
    if not a.flags.writeable:  # torch tensors over numpy memory must own it
        a = a.copy()
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def numpy_to_torch(a) -> torch.Tensor:
    """numpy (bf16 from ml_dtypes arrives as a 2-byte void kind and is read
    as bf16 bits) or torch → torch, on the CPU."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return from_bf16_bits(a.view(np.uint16))
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def pack_qm_tpu(q: np.ndarray, group_size: int | None = None) -> np.ndarray:
    """Pack uint4 codes ``q [OC, IC]`` (values 0..15) → QM_TPU
    ``packed [IC_pad//2, OC]`` uint8. With ``group_size``, IC is padded to
    ``padded_ic`` with the zero-point code."""
    oc, ic = q.shape
    if group_size is not None and padded_ic(ic, group_size) != ic:
        pad = padded_ic(ic, group_size) - ic
        q = np.concatenate(
            [q, np.full((oc, pad), ZERO_POINT_CODE, q.dtype)], axis=1)
        ic += pad
    assert ic % SUPERBLOCK == 0, f"IC={ic} must be a multiple of {SUPERBLOCK}"
    qt = q.astype(np.uint8).T
    qt = qt.reshape(ic // SUPERBLOCK, 2, PLANE, oc)
    lo, hi = qt[:, 0], qt[:, 1]
    # C order: numpy keeps the transposed input's layout otherwise
    return np.ascontiguousarray((lo | (hi << 4)).reshape(ic // 2, oc))


def unpack_qm_tpu(packed: np.ndarray) -> np.ndarray:
    """Inverse of pack_qm_tpu → uint8 codes [OC, IC] in [0, 15]."""
    icp, oc = packed.shape
    p = packed.reshape(icp // PLANE, PLANE, oc)
    lo = p & 0x0F
    hi = (p >> 4) & 0x0F
    qt = np.stack([lo, hi], axis=1).reshape(icp * 2, oc)
    return qt.T.copy()


def pack_scales(scales: np.ndarray, dtype: str = "f32",
                group_size: int | None = None) -> np.ndarray:
    """Quantizer scales ``[OC, IC//G]`` → kernel layout ``[IC//G, OC]``:
    float32, or bf16 bit patterns (uint16) for ``dtype="bf16"``. With
    ``group_size``, group rows pad to padded_ic//G with 0.0."""
    if group_size is not None:
        oc, sg = scales.shape
        sgp = padded_ic(sg * group_size, group_size) // group_size
        if sgp != sg:
            scales = np.concatenate(
                [scales, np.zeros((oc, sgp - sg), scales.dtype)], axis=1)
    out = np.ascontiguousarray(scales.T)
    if dtype == "bf16":
        return to_bf16_bits(out)
    assert dtype == "f32", dtype
    return out


def pad_to_superblock(w: np.ndarray) -> np.ndarray:
    """Zero-pad the IC axis (last) of ``w [OC, IC]`` up to a SUPERBLOCK
    multiple (tools use this for models whose dims aren't 256-aligned)."""
    oc, ic = w.shape
    rem = (-ic) % SUPERBLOCK
    if rem == 0:
        return w
    return np.concatenate([w, np.zeros((oc, rem), dtype=w.dtype)], axis=1)


def pack_qm_tpu_kn(q: torch.Tensor, group_size: int | None = None
                   ) -> torch.Tensor:
    """``pack_qm_tpu`` on K-major codes ``q [IC, OC]`` uint8 on any device:
    ``packed [IC_pad//2, OC]``, the same bytes as ``pack_qm_tpu(q.T)``."""
    ic, oc = q.shape
    if group_size is not None and padded_ic(ic, group_size) != ic:
        pad = padded_ic(ic, group_size) - ic
        q = torch.cat([q, torch.full((pad, oc), ZERO_POINT_CODE,
                                     dtype=q.dtype, device=q.device)])
        ic += pad
    assert ic % SUPERBLOCK == 0, f"IC={ic} must be a multiple of {SUPERBLOCK}"
    qt = q.to(torch.uint8).reshape(ic // SUPERBLOCK, 2, PLANE, oc)
    return (qt[:, 0] | (qt[:, 1] << 4)).reshape(ic // 2, oc)


def pack_scales_kn(scales: torch.Tensor, dtype: str = "f32",
                   group_size: int | None = None) -> torch.Tensor:
    """``pack_scales`` on K-major scales ``[IC//G, OC]`` f32 on any device:
    group rows padded to padded_ic//G with 0.0, then f32 or bf16 (round to
    nearest even, as ``to_bf16_bits``)."""
    if group_size is not None:
        sg, oc = scales.shape
        sgp = padded_ic(sg * group_size, group_size) // group_size
        if sgp != sg:
            scales = torch.cat([scales, scales.new_zeros((sgp - sg, oc))])
    if dtype == "bf16":
        return scales.to(torch.bfloat16).contiguous()
    assert dtype == "f32", dtype
    return scales.to(torch.float32).contiguous()
