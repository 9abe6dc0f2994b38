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
from tinychatengine_tpu_torch.quant.numerics import quantize_groupwise_int4
from tinychatengine_tpu_torch.quant.packing import (
    from_bf16_bits,
    pack_qm_tpu,
    pack_scales,
    padded_ic,
)

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


def fuse_linears(parts):
    """Concatenate same-K linears along N into one weight (the offline QKV /
    gate-up merge): one kernel launch streams all projections."""
    assert len({type(p) for p in parts}) == 1, "mixed linear kinds"

    def cat(field):
        arrs = [getattr(p, field) for p in parts]
        if any(a is None for a in arrs):
            assert all(a is None for a in arrs), f"partial {field}"
            return None
        return torch.cat(arrs, dim=-1)

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
    (GPTBigCode's init needs it; the llama init keeps uniform bytes)."""
    kp = padded_ic(k, group_size)
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


def quantized_linear(w_oc_ic: np.ndarray, group_size: int,
                     scale_dtype: str = "bf16", a8: bool = False,
                     device=None) -> Int4Linear:
    """float w [OC, IC] → Int4Linear / Int4A8Linear through the bit-exact
    quantizer and the QM_TPU packer."""
    q, scales = quantize_groupwise_int4(w_oc_ic, group_size)
    s = pack_scales(scales, scale_dtype, group_size)
    s = from_bf16_bits(s) if scale_dtype == "bf16" else torch.from_numpy(s)
    cls = Int4A8Linear if a8 else Int4Linear
    return cls(packed=torch.from_numpy(pack_qm_tpu(q, group_size)).to(device),
               scales=s.to(device))


def random_int4_linear(rng: np.random.Generator, k: int, n: int,
                       group_size: int = 128, std: float = 0.02,
                       scale_dtype: str = "f32", device=None) -> Int4Linear:
    """Random normal weights quantized on the host (tests and small
    models; real checkpoints come from tools.convert)."""
    w = (rng.standard_normal((n, k)) * std).astype(np.float32)
    return quantized_linear(w, group_size, scale_dtype, device=device)
