"""The Llama MLP, down(silu(x @ W_gate) * (x @ W_up)), in one kernel launch
(counterpart of the JAX package's ``ops/mlp_fused.py``).

The kernel is ``csrc/mlp_fused.cu``: one cooperative launch in four
phases split by grid-wide barriers. Phase A computes the fused gate_up
product in f32 band sums into a device scratch (the TPU kernel keeps gu
[M, 2F] in VMEM; on the H100 it stays in the 50 MB L2, 1.8 MB at M = 16 and
F = 14336); phase A2 sums gate and up over the bands, applies silu * mul
and rounds the activation to bf16 once into an [M, F] scratch (L2); phase
B runs the down contraction over it; phase C sums the down bands in K order
and rounds to bf16. Phases A and B are the tensor-core contraction of
``csrc/int4_mma.cuh`` (exact codes q - 8 by mma.sync into per-group f32
sums folded by fma), split over K by ``mlp_split``. No bf16 gu goes
through device memory.

Dispatch as everywhere in the port: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes ``mlp_fused_plain``. Like the JAX op, it is not
wired into the models; callers check ``mlp_fused_supported`` first.
"""

from __future__ import annotations

import torch

from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops.int4_matmul import (_P, _I, _check_layout,
                                                      _cuda_weights,
                                                      _mma_operand,
                                                      factored_int4,
                                                      mma_row_tile)
from tinychatengine_tpu_torch.quant.packing import SUPERBLOCK


def mlp_fused_supported(e_dim: int, f_dim: int, m: int,
                        bn: int = 2048) -> bool:
    """Shape gate (the JAX package's): tiles divide evenly and the gu
    scratch of at most 16 rows fits in 4 MiB."""
    if (2 * f_dim) % bn or e_dim % bn:
        return False
    if e_dim % SUPERBLOCK or f_dim % SUPERBLOCK:
        return False
    m_pad = m + (-m) % 16
    gu_bytes = m_pad * 2 * f_dim * 4
    return m_pad <= 16 and gu_bytes <= 4 * (1 << 20)


def _operands(x, wgate_up, down, layer_idx, bn):
    """Checks the call; returns (E, F, group size, rows)."""
    e_dim = x.shape[-1]
    f_dim = down.packed.shape[-2] * 2
    m = x.numel() // e_dim
    gs = wgate_up.group_size
    if wgate_up.packed.dim() != 3 or down.packed.dim() != 3 \
            or layer_idx is None:
        raise ValueError("mlp_fused takes layer-stacked gate_up and down "
                         "weights with layer_idx")
    if down.group_size != gs:
        raise ValueError(f"gate_up and down group sizes differ: {gs}, "
                         f"{down.group_size}")
    if wgate_up.packed.shape[-1] != 2 * f_dim \
            or down.packed.shape[-1] != e_dim \
            or 2 * wgate_up.packed.shape[-2] != e_dim:
        raise ValueError(f"gate_up {tuple(wgate_up.packed.shape)} and down "
                         f"{tuple(down.packed.shape)} are not [L, E/2, 2F] "
                         f"and [L, F/2, E] for E={e_dim}")
    if not mlp_fused_supported(e_dim, f_dim, m, bn):
        raise ValueError(f"mlp_fused does not take E={e_dim}, F={f_dim}, "
                         f"M={m}, bn={bn} (mlp_fused_supported)")
    _check_layout(x, wgate_up.packed, wgate_up.scales, gs, layer_idx)
    _check_layout(torch.empty((1, f_dim), device="meta"), down.packed,
                  down.scales, gs, layer_idx)
    return e_dim, f_dim, gs, m


def mlp_fused_plain(x, wgate_up, down, layer_idx, *,
                    bn: int = 2048) -> torch.Tensor:
    """The TPU kernel's arithmetic (``_mlp_kernel``, ``_dequant_dot``): x
    in bf16; gu = the factored contraction with ``dot * d - (8 sum x) *
    d`` per group, kept in f32 (never rounded to bf16); act = bf16(sigmoid(g)
    * g * u); the same contraction of act against W_down, rounded to bf16
    once."""
    e_dim, f_dim, gs, m = _operands(x, wgate_up, down, layer_idx, bn)
    li = int(layer_idx)
    xb = x.reshape(m, e_dim).to(torch.bfloat16)
    gu = factored_int4(xb, wgate_up.packed[li], wgate_up.scales[li], gs,
                       split_zero_point=True)
    gate, up = gu[:, :f_dim], gu[:, f_dim:]
    act = (torch.sigmoid(gate) * gate * up).to(torch.bfloat16)
    y = factored_int4(act, down.packed[li], down.scales[li], gs,
                      split_zero_point=True)
    return y.to(torch.bfloat16).reshape(x.shape)


# each phase's K split aims at about this many work items (two an SM of the
# H100's 132: at 16 rows, where two blocks fill an SM, more ran slower)
_MLP_TARGET_ITEMS = 264


def mlp_split(m: int, n: int, k: int) -> tuple[int, int]:
    """(superblocks per band, bands) of one phase of ``mlp_fused``'s kernel
    (``n`` columns, contraction depth ``k``) at ``m`` rows, until about
    ``_MLP_TARGET_ITEMS`` items of 128 columns and ``mma_row_tile(m)``
    rows: at the 16 rows or fewer the op takes, one row tile, so the split
    is a function of K and N alone."""
    items = -(-n // 128) * -(-m // mma_row_tile(m))
    nsb = k // SUPERBLOCK
    want = max(1, min(nsb, -(-_MLP_TARGET_ITEMS // items)))
    per = -(-nsb // want)
    return per, -(-nsb // per)


def mlp_fused(x, wgate_up, down, layer_idx, *, bn: int = 2048) -> torch.Tensor:
    """x [..., E]; wgate_up / down: layer-stacked ``Int4Linear``s ([L, E/2,
    2F] / [L, F/2, E]) with ``layer_idx``. Returns down(silu(gate) * up)
    [..., E] bf16 (the JAX package's signature). Raises ``ValueError``
    where ``mlp_fused_supported`` says no; on the card also where the grid
    cannot be co-resident (the launch is refused, it does not hang)."""
    if not x.is_cuda:
        return mlp_fused_plain(x, wgate_up, down, layer_idx, bn=bn)
    e_dim, f_dim, gs, m = _operands(x, wgate_up, down, layer_idx, bn)
    wa, sa = _cuda_weights(x, wgate_up.packed, wgate_up.scales, gs, layer_idx)
    wb, sb = _cuda_weights(x, down.packed, down.scales, gs, layer_idx)
    if wgate_up.scales.dtype != down.scales.dtype:
        raise ValueError("gate_up and down scales must share a dtype")
    x2 = x.reshape(m, e_dim).to(torch.bfloat16).contiguous()
    _mma_operand(x2, wb, sb, e_dim)
    x2 = _mma_operand(x2, wa, sa, 2 * f_dim)
    dev = x.device
    per_a, bands_a = mlp_split(m, 2 * f_dim, e_dim)
    per_b, bands_b = mlp_split(m, e_dim, f_dim)
    part_a = torch.empty((bands_a, m, 2 * f_dim), dtype=torch.float32,
                         device=dev)
    part_b = torch.empty((bands_b, m, e_dim), dtype=torch.float32, device=dev)
    act = torch.empty((m, f_dim), dtype=torch.bfloat16, device=dev)
    y = torch.empty((m, e_dim), dtype=torch.bfloat16, device=dev)
    fn = _build.bind("mlp_fused", "tce_mlp_fused",
                     [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P])
    _build.check(fn(x2.data_ptr(), wa, sa, wb, sb,
                    int(down.scales.dtype == torch.bfloat16),
                    part_a.data_ptr(), part_b.data_ptr(), act.data_ptr(),
                    y.data_ptr(), m, e_dim, f_dim, gs, per_a, bands_a, per_b,
                    bands_b, torch.cuda.current_stream(dev).cuda_stream),
                 "mlp_fused")
    _build.LAUNCHES["mlp_fused"] += 1
    return y.reshape(x.shape)
