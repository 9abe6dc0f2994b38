"""Linear-layer parameter containers and dispatch (counterpart of the JAX
package's ``ops/linear.py``).

Parameters are plain dataclasses of tensors; ``apply_linear`` dispatches on
the container type, so one model code runs fp, W4A16, W4A8 and W8A8. Layer-
stacked containers carry a leading [L] dim and are applied with
``layer_idx``: the int4 kernels then read the layer straight from the
stacked buffer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from tinychatengine_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_a8
from tinychatengine_tpu_torch.quant.numerics import quantize_groupwise_int4_kn
from tinychatengine_tpu_torch.quant.packing import (
    from_bf16_bits,
    pack_qm_tpu,
    pack_qm_tpu_kn,
    pack_scales,
    pack_scales_kn,
    pad_to_superblock,
    padded_ic,
)
from tinychatengine_tpu_torch.quant.packing import SUPERBLOCK

# M above which W4A8 runs the W4A16 kernel (the reference's own W4A8
# dispatch switches to a dequant + fp GEMM for m > 100)
A8_MAX_ROWS = 100


@dataclasses.dataclass
class DenseLinear:
    """Unquantized linear, weight stored K-major [K, N]."""

    weight: torch.Tensor
    bias: Optional[torch.Tensor] = None


@dataclasses.dataclass
class Int4Linear:
    """Group-wise INT4 linear in the QM_TPU layout: packed [K/2, N] uint8,
    scales [K/G, N] bf16 or f32."""

    packed: torch.Tensor
    scales: torch.Tensor
    bias: Optional[torch.Tensor] = None

    @property
    def group_size(self) -> int:
        return 2 * self.packed.shape[-2] // self.scales.shape[-2]


@dataclasses.dataclass
class Int4A8Linear(Int4Linear):
    """W4A8: the Int4Linear weights, activations quantized to int8 per
    (row, group) at matmul time."""


@dataclasses.dataclass
class W8A8Linear:
    """SmoothQuant static int8 linear: weight [K, N] int8, a scalar f32
    requant multiplier ``alpha`` and an optional f32 bias [N] (the int8
    bias already folded to fp32 by the converter).

    The weight is kept N-major: a [..., K, N] view of a contiguous
    [..., N, K] buffer (made so here if it is not), the operand layout
    cuBLASLt's int8 GEMM takes fastest; a row-major [K, N] weight ran
    ``torch._int_mm`` 4-14x slower at M <= 64 on the H100."""

    weight: torch.Tensor
    alpha: torch.Tensor
    bias: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.weight.stride(-2) != 1:
            self.weight = self.weight.transpose(-1, -2).contiguous() \
                .transpose(-1, -2)


def _at(t, layer_idx):
    return t if t is None or layer_idx is None else t[layer_idx]


# torch._int_mm on CUDA (cuBLASLt's int8 GEMM) takes M > 16 rows and K, N
# multiples of 8; fewer rows are zero-padded to this many
_INT_MM_ROWS = 32


def s8_matmul(x_s8: torch.Tensor, w_s8: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product, x [..., K] @ w [K, N] (never
    ``int8 @ int8`` in torch, which returns int8 and wraps; fp32 is not
    exact either once |sum| passes 2^24, and K = 16384 reaches 2^28).
    ``torch._int_mm`` accumulates in int32 on the CPU and on the card."""
    if x_s8.dtype != torch.int8 or w_s8.dtype != torch.int8:
        raise TypeError(f"s8_matmul takes int8 operands, got {x_s8.dtype} "
                        f"and {w_s8.dtype}")
    k, n = w_s8.shape
    x2 = x_s8.reshape(-1, k)
    m = x2.shape[0]
    if x2.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"int8 GEMM on CUDA needs K and N multiples of "
                             f"8, got K={k}, N={n}")
        if m < _INT_MM_ROWS:
            x2 = torch.nn.functional.pad(x2, (0, 0, 0, _INT_MM_ROWS - m))
    y = torch._int_mm(x2.contiguous(), w_s8)[:m]
    return y.reshape(*x_s8.shape[:-1], n)


def apply_linear(p, x: torch.Tensor, *, out_int8: bool = False,
                 relu: bool = False, layer_idx=None) -> torch.Tensor:
    """y = x @ W (+ bias), in x.dtype for DenseLinear and bf16 for the int4
    kinds. W8A8Linear takes int8 x and gives f32, or with ``out_int8`` the
    int8 requant clip(round(y)); ``relu`` applies before that (W8A8
    only)."""
    bias = _at(p.bias, layer_idx)
    if isinstance(p, W8A8Linear):
        acc = s8_matmul(x, _at(p.weight, layer_idx))
        y = acc.to(torch.float32) * _at(p.alpha, layer_idx)
        if bias is not None:
            y = y + bias.to(torch.float32)
        if relu:
            y = torch.clamp_min(y, 0.0)
        if out_int8:
            return torch.clamp(torch.round(y), -128, 127).to(torch.int8)
        return y
    if isinstance(p, DenseLinear):
        w = _at(p.weight, layer_idx)
        y = torch.matmul(x.float(), w.to(x.dtype).float()).to(x.dtype)
    elif isinstance(p, Int4A8Linear) \
            and math.prod(x.shape[:-1]) <= A8_MAX_ROWS:
        y = int4_matmul_a8(x, p.packed, p.scales, p.group_size,
                           layer_idx=layer_idx)
    elif isinstance(p, Int4Linear):
        y = int4_matmul(x, p.packed, p.scales, p.group_size,
                        layer_idx=layer_idx)
    else:
        raise TypeError(f"unknown linear params {type(p)}")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def row_parallel(p, x: torch.Tensor, tp_axis, **kw) -> torch.Tensor:
    """Row-parallel linear: the bias-less matmul summed over the TP axis
    (``parallel.distributed.Axis``), then the bias added once (a bias per
    shard would be summed tp_degree times: the Megatron bias rule). No
    reduction when tp_axis is None."""
    if tp_axis is None:
        return apply_linear(p, x, **kw)
    bias = getattr(p, "bias", None)
    if bias is None:
        return tp_axis.psum(apply_linear(p, x, **kw))
    y = tp_axis.psum(apply_linear(dataclasses.replace(p, bias=None), x,
                                  **kw))
    return y + _at(bias, kw.get("layer_idx")).to(y.dtype)


def fuse_linears(parts, tp_degree: int = 1):
    """Concatenate same-K linears along N into one weight (the offline QKV /
    gate-up merge): one kernel launch streams all projections.

    ``tp_degree``: the columns are laid out [p0_shard0 | p1_shard0 | ...
    | p0_shard1 | ...], so a column split over ``tp_degree`` ranks gives
    every rank its own contiguous [q_s | k_s | v_s] block, which the model
    code slices by local widths. 1 is the plain concatenation. The layout
    is specific to the degree; checkpoints record it."""
    assert len({type(p) for p in parts}) == 1, "mixed linear kinds"

    def cat(field):
        arrs = [getattr(p, field) for p in parts]
        if any(a is None for a in arrs):
            assert all(a is None for a in arrs), f"partial {field}"
            return None
        pieces = []
        for s in range(tp_degree):
            for a in arrs:
                w = a.shape[-1]
                assert w % tp_degree == 0, (field, tuple(a.shape), tp_degree)
                wl = w // tp_degree
                pieces.append(a[..., s * wl:(s + 1) * wl])
        return torch.cat(pieces, dim=-1)

    p0 = parts[0]
    if isinstance(p0, DenseLinear):
        return DenseLinear(weight=cat("weight"), bias=cat("bias"))
    return type(p0)(packed=cat("packed"), scales=cat("scales"),
                    bias=cat("bias"))


def _scale_dtype(name: str):
    assert name in ("bf16", "f32"), name
    return torch.bfloat16 if name == "bf16" else torch.float32


def random_int4_linear_fast(gen: torch.Generator, k: int, n: int,
                            group_size: int = 128, std: float = 0.02,
                            scale_dtype: str = "f32", device=None,
                            n_layers: Optional[int] = None,
                            centered: bool = False) -> Int4Linear:
    """Random packed bytes and scales made on ``device`` from ``gen`` (a
    generator on that device): only shapes and layout matter (benchmarks).
    With ``n_layers`` the leaves are stacked [L, ...], filled layer by layer
    so no temporary of the whole stack is made. ``centered``: each code
    uniform over 1..15, symmetric about the zero point as a quantized
    zero-mean weight's codes are, instead of uniform bytes, whose codes
    average 7.5 and so put a common -0.5 * d * sum(x) into every output
    (GPTBigCode's init needs it; the llama init keeps uniform bytes). K is
    padded to whole superblocks (a sparse-expert down projection's 896)."""
    kp = -(-padded_ic(k, group_size) // SUPERBLOCK) * SUPERBLOCK
    lead = () if n_layers is None else (n_layers,)
    packed = torch.empty(lead + (kp // 2, n), dtype=torch.uint8, device=device)
    scales = torch.empty(lead + (kp // group_size, n),
                         dtype=_scale_dtype(scale_dtype), device=device)
    for p, s in zip(packed.view(-1, kp // 2, n),
                    scales.view(-1, kp // group_size, n)):
        if centered:
            lo, hi = (torch.randint(1, 16, p.shape, dtype=torch.uint8,
                                    device=device, generator=gen)
                      for _ in range(2))
            p.copy_(lo | (hi << 4))
        else:
            p.copy_(torch.randint(0, 256, p.shape, dtype=torch.uint8,
                                  device=device, generator=gen))
        u = torch.rand(s.shape, dtype=torch.float32, device=device,
                       generator=gen)
        s.copy_((u + 0.5) * (std / 4.0))
    return Int4Linear(packed=packed, scales=scales)


def quantized_linear_kn(w_kn: torch.Tensor, group_size: int,
                        scale_dtype: str = "bf16", a8: bool = False,
                        bias: Optional[torch.Tensor] = None) -> Int4Linear:
    """float w [K, N] tensor → Int4Linear / Int4A8Linear on its device
    through the torch quantizer and packer (``quantize_groupwise_int4_kn``,
    ``pack_qm_tpu_kn``): the bytes of numpy's ``quantize_groupwise_int4``
    and ``pack_qm_tpu`` on ``w.T`` (``int4_linear_from_codes``)."""
    q, scales = quantize_groupwise_int4_kn(w_kn, group_size)
    cls = Int4A8Linear if a8 else Int4Linear
    return cls(packed=pack_qm_tpu_kn(q, group_size),
               scales=pack_scales_kn(scales, scale_dtype, group_size),
               bias=bias)


def quantized_linear(w_oc_ic: np.ndarray, group_size: int,
                     scale_dtype: str = "bf16", a8: bool = False,
                     device=None) -> Int4Linear:
    """float w [OC, IC] → Int4Linear / Int4A8Linear on ``device`` through
    the bit-exact quantizer and the QM_TPU packer (``quantized_linear_kn``
    on the K-major weight: numpy's ``quantize_groupwise_int4`` bytes)."""
    w = torch.from_numpy(np.ascontiguousarray(w_oc_ic, np.float32))
    return quantized_linear_kn(w.to(device).T, group_size, scale_dtype, a8)


def int4_linear_from_codes(q: np.ndarray, scales: np.ndarray,
                           group_size: int, scale_dtype: str = "bf16",
                           a8: bool = False, device=None,
                           bias: Optional[torch.Tensor] = None) -> Int4Linear:
    """Codes [OC, IC] in [0, 15] and their scales [OC, IC // group_size]
    (numpy) → Int4Linear / Int4A8Linear packed in QM_TPU on ``device``."""
    s = pack_scales(scales, scale_dtype, group_size)
    s = from_bf16_bits(s) if scale_dtype == "bf16" else torch.from_numpy(s)
    cls = Int4A8Linear if a8 else Int4Linear
    return cls(packed=torch.from_numpy(pack_qm_tpu(q, group_size)).to(device),
               scales=s.to(device), bias=bias)


def random_int4_linear(rng: np.random.Generator, k: int, n: int,
                       group_size: int = 128, std: float = 0.02,
                       scale_dtype: str = "f32", device=None) -> Int4Linear:
    """Random normal weights quantized on the host (tests and small
    models; real checkpoints come from tools.convert), K zero-padded to
    whole superblocks (``pad_to_superblock``)."""
    w = (rng.standard_normal((n, k)) * std).astype(np.float32)
    return quantized_linear(pad_to_superblock(w), group_size, scale_dtype,
                            device=device)
