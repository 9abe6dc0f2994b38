"""INT3 fused dequant matmul, the W3 experiment (counterpart of the JAX
package's ``ops/int3_matmul.py``): weights at 3/8 byte each, 75 % of int4.

Layout (QM_TPU3, two bitplanes, each unpacked like the int4 nibble planes):

* plane A (low 2 bits): ``packed_a [IC/4, OC] uint8``; within a superblock
  of 4 * PLANE input rows, byte row i bits [2j, 2j+1] hold
  w[s*4*PLANE + j*PLANE + i] & 3;
* plane B (high bit): ``packed_b [IC/8, OC] uint8``; within a superblock of
  8 * PLANE rows, byte row i bit j holds bit 2 of w[s*8*PLANE + j*PLANE + i].

Codes q = A + 4B in [0, 7], dequant (q - 4) * d (``quant/numerics.py``).
The kernels fold the zero point and the B plane out of the per-element path:
x . ((A + 4B - 4) d) = d (x . A) + 4 d (x . B) - 4 d sum x.

The kernel is ``csrc/int3_matmul.cu`` (the codes as bf16 A + 4B - 4 on
the tensor cores, per-group f32 sums folded with their scales, K split by
``int3_split``); a CUDA tensor launches it (or raises), a CPU tensor takes
``int3_matmul_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops.int4_matmul import (_I, _P, mma_row_tile,
                                                      split_k)

PLANE = 128
SB_A = 4 * PLANE     # input rows per A-plane superblock
SB_B = 8 * PLANE     # input rows per B-plane superblock
ZERO_POINT3 = 4.0


def pack_qm_tpu3(q: np.ndarray):
    """uint3 codes ``q [OC, IC]`` (values 0..7) → (packed_a [IC/4, OC],
    packed_b [IC/8, OC]). IC must be a multiple of 8 * PLANE (pad with the
    zero-point code 4 upstream if needed: it dequantizes to exactly 0)."""
    oc, ic = q.shape
    assert ic % SB_B == 0, f"IC={ic} must be a multiple of {SB_B}"
    qt = q.astype(np.uint8).T                        # [IC, OC]
    a = (qt & 3).reshape(ic // SB_A, 4, PLANE, oc)
    packed_a = (a[:, 0] | (a[:, 1] << 2) | (a[:, 2] << 4)
                | (a[:, 3] << 6)).reshape(ic // 4, oc)
    b = ((qt >> 2) & 1).reshape(ic // SB_B, 8, PLANE, oc)
    packed_b = np.zeros((ic // SB_B, PLANE, oc), np.uint8)
    for j in range(8):
        packed_b |= b[:, j] << j
    return (np.ascontiguousarray(packed_a),
            np.ascontiguousarray(packed_b.reshape(ic // 8, oc)))


def unpack_qm_tpu3(packed_a: np.ndarray, packed_b: np.ndarray) -> np.ndarray:
    """Inverse of ``pack_qm_tpu3`` → uint8 codes [OC, IC] in [0, 7]."""
    ica4, oc = packed_a.shape
    a = packed_a.reshape(-1, PLANE, oc)
    qa = np.stack([(a >> (2 * j)) & 3 for j in range(4)],
                  axis=1).reshape(ica4 * 4, oc)
    b = packed_b.reshape(-1, PLANE, oc)
    qb = np.stack([(b >> j) & 1 for j in range(8)],
                  axis=1).reshape(ica4 * 4, oc)
    return (qa | (qb << 2)).T.copy()


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def int3_matmul_ref(x, packed_a, packed_b, scales, group_size: int):
    """Oracle: dequantize fully in f32, one product, bf16 out (the JAX
    package's ``int3_matmul_ref``)."""
    q = torch.from_numpy(unpack_qm_tpu3(_numpy(packed_a), _numpy(packed_b)))
    oc, ic = q.shape
    d = torch.as_tensor(_numpy(scales), dtype=torch.float32).T  # [OC, IC/G]
    w = ((q.float().reshape(oc, ic // group_size, group_size) - ZERO_POINT3)
         * d[..., None]).reshape(oc, ic)
    xf = torch.as_tensor(x).float().cpu()
    return (xf @ w.T).to(torch.bfloat16)


def _pick(dim: int, preferred: int) -> int:
    b = min(preferred, dim)
    while b > 1 and dim % b != 0:
        b //= 2
    return b


def _operands(x, packed_a, packed_b, scales, group_size, block_k):
    """Checks of a call (the JAX op's, as ValueError): 2-D x [M, K] and
    unstacked planes [K/4, N] / [K/8, N], scales [K/G, N], and the K block
    the JAX op picks a multiple of ``SB_B``. Returns (M, K, N)."""
    if x.dim() != 2 or packed_a.dim() != 2 or packed_b.dim() != 2:
        raise ValueError("int3_matmul takes x [M, K] and unstacked 2-D "
                         "weights")
    m, k = x.shape
    n = packed_a.shape[-1]
    if tuple(packed_a.shape) != (k // 4, n) \
            or tuple(packed_b.shape) != (k // 8, n) \
            or group_size > PLANE or PLANE % group_size \
            or tuple(scales.shape) != (k // group_size, n):
        raise ValueError(
            f"x [{m}, {k}] does not fit planes {tuple(packed_a.shape)}, "
            f"{tuple(packed_b.shape)}, scales {tuple(scales.shape)}, group "
            f"{group_size}")
    if _pick(k, block_k) % SB_B:
        raise ValueError(f"K={k} takes no K block that is a multiple of "
                         f"{SB_B} (block_k {block_k})")
    return m, k, n


def int3_matmul_plain(x, packed_a, packed_b, scales, *, group_size: int = 128,
                      block_k: int = 2048) -> torch.Tensor:
    """The TPU kernel's arithmetic (``_int3_kernel``): x in bf16, the two
    planes' exact bits, f32 scales, per group ``acc += (x . A + 4 x . B -
    4 sum x) * d`` in f32, rounded to bf16 once."""
    m, k, n = _operands(x, packed_a, packed_b, scales, group_size, block_k)
    ng = k // group_size
    xg = x.to(torch.bfloat16).float().reshape(m, ng, group_size)
    a = packed_a.reshape(k // SB_A, PLANE, n)
    qa = torch.stack([(a >> (2 * j)) & 3 for j in range(4)], dim=1)
    b = packed_b.reshape(k // SB_B, PLANE, n)
    qb = torch.stack([(b >> j) & 1 for j in range(8)], dim=1)
    qa = qa.reshape(ng, group_size, n).float()
    qb = qb.reshape(ng, group_size, n).float()
    dot_a = torch.einsum("mgk,gkn->mgn", xg, qa)
    dot_b = torch.einsum("mgk,gkn->mgn", xg, qb)
    xsum4 = xg.sum(dim=-1, keepdim=True) * ZERO_POINT3
    acc = ((dot_a + 4.0 * dot_b - xsum4) * scales.float()[None]).sum(dim=1)
    return acc.to(torch.bfloat16)


# the int3 kernel splits K until about this many blocks are launched: two
# 8-row blocks share an SM (94-107 KB of shared memory each), one block of
# 16 rows or more
_INT3_TARGET_BLOCKS = 264
_INT3_TARGET_BLOCKS_WIDE = 132


def int3_split(m: int, n: int, k: int) -> tuple[int, int]:
    """(chunks of ``SB_B`` rows per band, bands) of ``int3_matmul``'s kernel
    at ``m`` rows over blocks of 128 columns and ``mma_row_tile(m)`` rows: a
    function of K and N alone up to 8 rows (one row tile), so a row's bits
    do not depend on how many rows ride along."""
    tile = mma_row_tile(m)
    target = _INT3_TARGET_BLOCKS if tile == 8 else _INT3_TARGET_BLOCKS_WIDE
    return split_k(k // SB_B, -(-n // 128) * -(-m // tile), target)


def int3_matmul(x, packed_a, packed_b, scales, *, group_size: int = 128,
                block_k: int = 2048) -> torch.Tensor:
    """y = x @ dequant(W3): x [M, K] → [M, N] bf16. Unstacked 2-D weights,
    f32 scales; ``block_k`` is the JAX op's K block, which here only
    decides what it refuses. CUDA: ``csrc/int3_matmul.cu`` (mma.sync over
    blocks of 128 columns and ``mma_row_tile(M)`` rows, K split by
    ``int3_split``, the bands added in K order); CPU:
    ``int3_matmul_plain``."""
    if not x.is_cuda:
        return int3_matmul_plain(x, packed_a, packed_b, scales,
                                 group_size=group_size, block_k=block_k)
    m, k, n = _operands(x, packed_a, packed_b, scales, group_size, block_k)
    dev = x.device
    for t, what in ((packed_a, "packed_a"), (packed_b, "packed_b")):
        if t.device != dev or t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous uint8 on {dev}")
    if scales.device != dev or scales.dtype != torch.float32 \
            or not scales.is_contiguous():
        raise ValueError(f"scales must be contiguous f32 on {dev}")
    if n % 16 or group_size not in (32, 64, 128):
        raise ValueError(f"kernel needs N % 16 == 0 and G in (32, 64, 128); "
                         f"got N={n}, G={group_size}")
    if (packed_a.data_ptr() | packed_b.data_ptr() | scales.data_ptr()) % 16:
        raise ValueError("the int3 kernel needs 16-byte aligned planes and "
                         "scales")
    x2 = x.to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    per, bands = int3_split(m, n, k)
    partial = torch.empty((bands, m, n), dtype=torch.float32, device=dev)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    fn = _build.bind("int3_matmul", "tce_int3_matmul",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    _build.check(fn(x2.data_ptr(), packed_a.data_ptr(), packed_b.data_ptr(),
                    scales.data_ptr(), partial.data_ptr(), y.data_ptr(), m, k,
                    n, group_size, per, bands,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "int3_matmul")
    _build.LAUNCHES["int3_matmul"] += 1
    return y
