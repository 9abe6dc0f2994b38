"""Fused dequant-INT4 matmuls: W4A16 (``int4_matmul``) and W4A8
(``int4_matmul_a8``), with their plain PyTorch versions.

Counterpart of the JAX package's ``ops/int4_matmul.py``. The kernels are
``csrc/int4_matmul.cu`` and ``csrc/int4_matmul_a8.cu``. Both read the QM_TPU
packed layout as stored (``quant/packing.py``): ``packed [K/2, N]`` uint8,
or layer-stacked ``[L, K/2, N]`` with ``layer_idx`` selecting the layer by a
pointer offset (no per-layer copy); ``scales [K/G, N]`` (or ``[L, K/G, N]``)
in bf16 or f32. A pack-padded K (``packing.padded_ic``) is handled by
zero-padding x: the pad rows hold the zero-point code and dequantize to 0.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain version. The plain versions keep the JAX fallbacks' cast points
(``int4_matmul_xla`` / ``int4_matmul_a8_xla``).
"""

from __future__ import annotations

import ctypes

import torch

from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops.ref import dequantize_int4
from tinychatengine_tpu_torch.quant.packing import PLANE, SUPERBLOCK

_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_layout(x, packed, scales, group_size, layer_idx):
    """Shapes of one call; raises on any the kernels or the layout refuse.
    Returns (K of x, packed K, N)."""
    stacked = packed.dim() == 3
    if stacked != (layer_idx is not None) or packed.dim() not in (2, 3) \
            or scales.dim() != packed.dim():
        raise ValueError("layer_idx is given iff packed/scales are stacked "
                         "[L, K/2, N] / [L, K/G, N]")
    if stacked and not 0 <= int(layer_idx) < packed.shape[0]:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {packed.shape[0]})")
    k = x.shape[-1]
    kp, n = packed.shape[-2:]
    kw = 2 * kp
    if not (group_size <= PLANE and PLANE % group_size == 0
            and kw >= k and (kw - k) % group_size == 0
            and kw % SUPERBLOCK == 0
            and tuple(scales.shape[-2:]) == (kw // group_size, n)):
        raise ValueError(
            f"x [..., {k}] does not fit packed {tuple(packed.shape)}, scales "
            f"{tuple(scales.shape)}, group {group_size} (packed K a multiple "
            f"of {SUPERBLOCK}, at most one pack pad of whole groups)")
    return k, kw, n


def _layer(t: torch.Tensor, layer_idx):
    return t if layer_idx is None else t[int(layer_idx)]


def _cuda_args(x, packed, scales, group_size, layer_idx):
    """Checks shared by both kernels; returns the 2-D zero-padded bf16 x,
    the layer's weight and scale pointers and the shape numbers."""
    k, kw, n = _check_layout(x, packed, scales, group_size, layer_idx)
    if not (packed.is_cuda and scales.is_cuda and x.device == packed.device):
        raise ValueError("x, packed and scales must lie on one CUDA device")
    if packed.dtype != torch.uint8 or not packed.is_contiguous():
        raise ValueError("packed must be contiguous uint8")
    if scales.dtype not in (torch.bfloat16, torch.float32) \
            or not scales.is_contiguous():
        raise ValueError("scales must be contiguous bf16 or f32")
    if n % 4 or group_size not in (32, 64, 128):
        raise ValueError(f"kernel needs N % 4 == 0 and G in (32, 64, 128); "
                         f"got N={n}, G={group_size}")
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if kw > k:
        x2 = torch.nn.functional.pad(x2, (0, kw - k))
    x2 = x2.contiguous()
    li = 0 if layer_idx is None else int(layer_idx)
    w_ptr = packed.data_ptr() + li * (kw // 2) * n
    s_ptr = scales.data_ptr() + li * (kw // group_size) * n * scales.element_size()
    return x2, w_ptr, s_ptr, kw, n


def int4_matmul_plain(x, packed, scales, group_size: int = 128, *,
                      layer_idx=None) -> torch.Tensor:
    """Dequantize to bf16, then matmul with f32 accumulation; result in
    x.dtype (``int4_matmul_xla``)."""
    k, _, _ = _check_layout(x, packed, scales, group_size, layer_idx)
    w = dequantize_int4(_layer(packed, layer_idx), _layer(scales, layer_idx),
                        group_size, torch.bfloat16)[:k]
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float())
    return y.to(x.dtype)


def int4_matmul(x, packed, scales, group_size: int = 128, *,
                layer_idx=None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ ((q - 8) * d), bf16 out. CUDA: the W4A16
    kernel (``csrc/int4_matmul.cu``); CPU: ``int4_matmul_plain``."""
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scales, group_size,
                                 layer_idx=layer_idx)
    x2, w_ptr, s_ptr, kw, n = _cuda_args(x, packed, scales, group_size,
                                         layer_idx)
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    fn = _build.bind("int4_matmul", "tce_int4_matmul",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    _build.check(fn(x2.data_ptr(), w_ptr, s_ptr, y.data_ptr(), m, kw, n,
                    group_size, int(scales.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "int4_matmul")
    _build.LAUNCHES["int4_matmul"] += 1
    return y.reshape(*x.shape[:-1], n)


def int4_matmul_a8_plain(x, packed, scales, group_size: int = 128, *,
                         layer_idx=None) -> torch.Tensor:
    """Fake-quantized int8 activations (per row and group: absmax/127,
    round half to even, clip to +-127) times the f32-dequantized weights,
    bf16 out (``int4_matmul_a8_xla``)."""
    k, _, _ = _check_layout(x, packed, scales, group_size, layer_idx)
    x2 = x.reshape(-1, k).float()
    g = x2.reshape(x2.shape[0], k // group_size, group_size)
    absmax = g.abs().amax(dim=-1, keepdim=True)
    a_scale = torch.clamp(absmax, min=1e-8) / 127.0
    q_a = torch.clamp(torch.round(g / a_scale), -127, 127)
    xq = (q_a * a_scale).reshape(x2.shape)
    w = dequantize_int4(_layer(packed, layer_idx), _layer(scales, layer_idx),
                        group_size, torch.float32)[:k]
    y = torch.matmul(xq, w)
    return y.to(torch.bfloat16).reshape(*x.shape[:-1], -1)


# split K over blocks until about this many blocks are in flight
# (two per SM of the H100's 132)
_A8_TARGET_BLOCKS = 264


def int4_matmul_a8(x, packed, scales, group_size: int = 128, *,
                   layer_idx=None) -> torch.Tensor:
    """W4A8: activations quantized to int8 per (row, group) at run time,
    int32 group dots. CUDA: ``csrc/int4_matmul_a8.cu``; CPU:
    ``int4_matmul_a8_plain``."""
    if not x.is_cuda:
        return int4_matmul_a8_plain(x, packed, scales, group_size,
                                    layer_idx=layer_idx)
    x2, w_ptr, s_ptr, kw, n = _cuda_args(x, packed, scales, group_size,
                                         layer_idx)
    m = x2.shape[0]
    dev = x.device
    mt = 1 if m == 1 else 8
    blocks = -(-n // 128) * -(-m // mt)
    ksplit = max(1, min(_A8_TARGET_BLOCKS // blocks, kw // SUPERBLOCK))
    qa = torch.empty((m, kw), dtype=torch.int8, device=dev)
    ascale = torch.empty((m, kw // group_size), dtype=torch.float32, device=dev)
    partial = torch.empty((ksplit, m, n) if ksplit > 1 else (1,),
                          dtype=torch.float32, device=dev)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    fn = _build.bind("int4_matmul_a8", "tce_int4_matmul_a8",
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    _build.check(fn(x2.data_ptr(), w_ptr, s_ptr, qa.data_ptr(),
                    ascale.data_ptr(), partial.data_ptr(), y.data_ptr(), m, kw,
                    n, group_size, int(scales.dtype == torch.bfloat16), ksplit,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "int4_matmul_a8")
    _build.LAUNCHES["int4_matmul_a8"] += 1
    return y.reshape(*x.shape[:-1], n)
