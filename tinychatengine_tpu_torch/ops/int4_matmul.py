"""Fused dequant-INT4 matmuls: W4A16 (``int4_matmul``), W4A8
(``int4_matmul_a8``) and the decode matmul with its norm, RoPE, bias and
residual folded in (``int4_matmul_fused``), with their plain PyTorch
versions.

Counterpart of the JAX package's ``ops/int4_matmul.py``. The kernels are
``csrc/int4_matmul.cu``, ``csrc/int4_matmul_a8.cu`` and
``csrc/int4_matmul_fused.cu``. They read the QM_TPU
packed layout as stored (``quant/packing.py``): ``packed [K/2, N]`` uint8,
or layer-stacked ``[L, K/2, N]`` with ``layer_idx`` selecting the layer by a
pointer offset (no per-layer copy); ``scales [K/G, N]`` (or ``[L, K/G, N]``)
in bf16 or f32. A pack-padded K (``packing.padded_ic``) is handled by
zero-padding x: the pad rows hold the zero-point code and dequantize to 0.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain version. The plain versions keep the JAX fallbacks' cast points
(``int4_matmul_xla`` / ``int4_matmul_a8_xla``); the fused one follows the
TPU kernel's body (``_fused_kernel``) instead.

``FUSED_DECODE`` is the fused decode switch (the JAX package's flag of the
same name): the model forwards read it at call time and, when it is on, run
their one-token steps through ``int4_matmul_fused``. Off by default, as in
JAX; the environment variable ``TINYCHAT_DECODE_FUSED=1`` turns it on at
import, and code may set the attribute at any time.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops.ref import (ZERO_POINT, dequantize_int4,
                                              unpack_int4)
from tinychatengine_tpu_torch.quant.packing import PLANE, SUPERBLOCK

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

FUSED_DECODE = os.environ.get("TINYCHAT_DECODE_FUSED", "0") not in ("", "0")


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


def _fused_operands(x, packed, scales, group_size, layer_idx, norm_w, norm_b,
                    bias):
    """The fused call's weights as a stack: an unstacked [K/2, N] weight is
    wrapped as L = 1 (with its [K] norm and [N] bias), as in JAX. Checks the
    shapes; returns (packed, scales, layer, norm_w, norm_b, bias)."""
    if packed.dim() == 2:
        if layer_idx is not None:
            raise ValueError("layer_idx is given iff packed is stacked")
        packed, scales, layer_idx = packed[None], scales[None], 0
        norm_w, norm_b, bias = (None if t is None else t.reshape(1, -1)
                                for t in (norm_w, norm_b, bias))
    k, kw, n = _check_layout(x, packed, scales, group_size, layer_idx)
    if kw != k:
        raise ValueError(
            f"fused decode needs unpadded K (the norm runs over the whole "
            f"row): x has K={k}, packed {kw}; use the unfused path")
    if norm_b is not None and norm_w is None:
        raise ValueError("norm_b (LayerNorm) needs norm_w")
    n_layers = packed.shape[0]
    for t, width, what in ((norm_w, k, "norm_w"), (norm_b, k, "norm_b"),
                           (bias, n, "bias")):
        if t is not None and tuple(t.shape) != (n_layers, width):
            raise ValueError(f"{what} {tuple(t.shape)} is not "
                             f"[{n_layers}, {width}]")
    return packed, scales, int(layer_idx), norm_w, norm_b, bias


def int4_matmul_fused_plain(x, packed, scales, group_size: int = 128, *,
                            layer_idx=None, norm_w=None, norm_b=None,
                            norm_eps: float = 1e-5, rope_cos=None,
                            rope_sin=None, rope_qk_cols: int = 0,
                            head_dim: int = 128, bias=None,
                            residual=None) -> torch.Tensor:
    """The TPU kernel's body step by step, bf16 out: the norm in f32 with
    JAX's op order, rounded to bf16 (LayerNorm when ``norm_b`` rides along,
    else RMSNorm); per group d * (x . q) - 8 d * sum(x) with the exact codes
    and f32 scales; the output rounded to bf16; RoPE in f32 on the leading
    ``rope_qk_cols`` columns, rounded once; the bias (rounded to bf16) added
    in f32 and rounded; the residual added in f32 and rounded."""
    packed, scales, li, norm_w, norm_b, bias = _fused_operands(
        x, packed, scales, group_size, layer_idx, norm_w, norm_b, bias)
    k, n = x.shape[-1], packed.shape[-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    m = x2.shape[0]
    xf = x2.float()
    if norm_b is not None:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        xn = ((xf - mu) * torch.rsqrt(var + norm_eps) * norm_w[li].float()
              + norm_b[li].float()).to(torch.bfloat16)
    elif norm_w is not None:
        rs = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + norm_eps)
        xn = (xf * rs * norm_w[li].float()).to(torch.bfloat16)
    else:
        xn = x2
    ng = k // group_size
    xg = xn.float().reshape(m, ng, group_size)
    codes = unpack_int4(packed[li]).float().reshape(ng, group_size, n)
    dot = torch.einsum("mgk,gkn->mgn", xg, codes)
    xsum8 = xg.sum(dim=-1, keepdim=True) * ZERO_POINT
    acc = ((dot - xsum8) * scales[li].float()[None]).sum(dim=1)
    y = acc.to(torch.bfloat16)
    if rope_cos is not None:
        if rope_qk_cols % head_dim or head_dim % 2:
            raise ValueError("rope_qk_cols must be whole heads of even D")
        half = head_dim // 2
        cos = rope_cos.reshape(m, 1, head_dim).float()
        sin = rope_sin.reshape(m, 1, head_dim).float()
        qk = y[:, :rope_qk_cols].float().reshape(m, -1, head_dim)
        rot = torch.cat([-qk[..., half:], qk[..., :half]], dim=-1)
        roped = (qk * cos + rot * sin).to(torch.bfloat16)
        y = torch.cat([roped.reshape(m, -1), y[:, rope_qk_cols:]], dim=1)
    if bias is not None:
        y = (y.float() + bias[li].to(torch.bfloat16).float()
             ).to(torch.bfloat16)
    if residual is not None:
        y = (y.float() + residual.reshape(m, n).float()).to(torch.bfloat16)
    return y.reshape(*x.shape[:-1], n)


def _vec_arg(t, li: int, width: int, device, what: str):
    """(pointer to layer li of a stacked [L, width] bf16/f32 CUDA tensor, is
    bf16) or (None, 0) for an absent operand."""
    if t is None:
        return None, 0
    if t.device != device or t.dtype not in (torch.bfloat16, torch.float32) \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous bf16 or f32 on {device}")
    return (t.data_ptr() + li * width * t.element_size(),
            int(t.dtype == torch.bfloat16))


# split K over blocks until about this many blocks are in flight (two per SM
# of the H100's 132), as int4_matmul_a8 does
_FUSED_TARGET_BLOCKS = 264


def fused_split(m: int, n: int, k: int) -> tuple[int, int]:
    """(superblocks per K split, number of splits) of the fused kernel's
    grid: 128 columns and 8 rows (1 at M = 1) per block."""
    tiles = -(-n // 128) * -(-m // (1 if m == 1 else 8))
    nsb = k // SUPERBLOCK
    want = max(1, min(nsb, -(-_FUSED_TARGET_BLOCKS // tiles)))
    per = -(-nsb // want)
    return per, -(-nsb // per)


def int4_matmul_fused(x, packed, scales, group_size: int = 128, *,
                      layer_idx=None, norm_w=None, norm_b=None,
                      norm_eps: float = 1e-5, rope_cos=None, rope_sin=None,
                      rope_qk_cols: int = 0, head_dim: int = 128, bias=None,
                      residual=None) -> torch.Tensor:
    """Decode matmul with an optional norm prologue and RoPE / bias /
    residual epilogues: y = rope(norm(x) @ dequant(W)) (+ bias) (+ residual),
    bf16 out (the JAX package's signature).

    x [..., K]; packed / scales stacked [L, K/2, N] / [L, K/G, N] with
    ``layer_idx``, or unstacked (wrapped as L = 1); K must be unpadded.
    norm_w [L, K] (or [K]): RMSNorm, or LayerNorm when ``norm_b`` rides
    along. rope_cos / rope_sin [M, head_dim]: rotate-half RoPE on the
    leading ``rope_qk_cols`` output columns. bias [L, N] (or [N]); residual
    shaped like the output (the JAX package's arguments, less its TPU
    tiling and interpret mode). CUDA: ``csrc/int4_matmul_fused.cu``; CPU:
    ``int4_matmul_fused_plain``."""
    args = dict(layer_idx=layer_idx, norm_w=norm_w, norm_b=norm_b,
                norm_eps=norm_eps, rope_cos=rope_cos, rope_sin=rope_sin,
                rope_qk_cols=rope_qk_cols, head_dim=head_dim, bias=bias,
                residual=residual)
    if not x.is_cuda:
        return int4_matmul_fused_plain(x, packed, scales, group_size, **args)
    packed, scales, li, norm_w, norm_b, bias = _fused_operands(
        x, packed, scales, group_size, layer_idx, norm_w, norm_b, bias)
    x2, w_ptr, s_ptr, k, n = _cuda_args(x, packed, scales, group_size, li)
    if x2.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x2 = x2.clone()
    m, dev = x2.shape[0], x.device
    nw_ptr, nw_bf16 = _vec_arg(norm_w, li, k, dev, "norm_w")
    nb_ptr, nb_bf16 = _vec_arg(norm_b, li, k, dev, "norm_b")
    b_ptr, b_bf16 = _vec_arg(bias, li, n, dev, "bias")
    cos = sin = None
    qk_cols = 0
    if rope_cos is not None:
        if rope_qk_cols % head_dim or head_dim % 2 or rope_qk_cols > n:
            raise ValueError("rope_qk_cols must be whole heads of even D "
                             "within N")
        cos, sin = (t.reshape(-1, head_dim).to(device=dev, dtype=torch.float32)
                    .contiguous() for t in (rope_cos, rope_sin))
        if cos.shape[0] != m or sin.shape != cos.shape:
            raise ValueError(f"rope cos/sin need {m} rows of {head_dim}")
        qk_cols = int(rope_qk_cols)
    res = None
    if residual is not None:
        res = residual.reshape(m, n).to(device=dev, dtype=torch.bfloat16
                                        ).contiguous()
    per, ksplit = fused_split(m, n, k)
    partial = torch.empty((ksplit, m, n), dtype=torch.float32, device=dev)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    fn = _build.bind("int4_matmul_fused", "tce_int4_matmul_fused",
                     [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P, _I, _P, _I, _F, _P, _P, _I, _I, _P, _I, _P, _P])
    _build.check(fn(x2.data_ptr(), w_ptr, s_ptr,
                    int(scales.dtype == torch.bfloat16), partial.data_ptr(),
                    y.data_ptr(), m, k, n, group_size, per, ksplit,
                    nw_ptr, nw_bf16, nb_ptr, nb_bf16, float(norm_eps),
                    None if cos is None else cos.data_ptr(),
                    None if sin is None else sin.data_ptr(), qk_cols,
                    int(head_dim), b_ptr, b_bf16,
                    None if res is None else res.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream),
                 "int4_matmul_fused")
    _build.LAUNCHES["int4_matmul_fused"] += 1
    return y.reshape(*x.shape[:-1], n)
