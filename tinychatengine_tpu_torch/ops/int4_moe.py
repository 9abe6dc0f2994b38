"""The sparse-expert layer's ops (``models/moe.py``), with their plain
PyTorch versions: the router's top-k (``route``), the plan that sorts the
routed (row, expert) pairs by expert (``plan``), the grouped W4A16 expert
matmul (``grouped_int4_matmul``), SiLU(gate) * up (``expert_act``) and the
weighted combine with the residual (``combine``).

The kernels are ``csrc/int4_moe.cu``; the grouped matmul runs the int4
tile route's pieces (``csrc/int4_tile.cuh``, shared with ``int4_matmul``)
at the cast point bf16((q - 8) * d) with f32 sums, K never split, so a
row's bits depend on its own x row alone. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain version, a loop over the
experts.

Expert weights: every (layer, expert) of one projection in one stack,
``packed [L E, K/2, N]`` uint8 and ``scales [L E, K/G, N]`` in the QM_TPU
layout; a layer's experts are sets ``e0 .. e0 + E - 1`` (``e0 = layer *
E``), read by an offset into the stack, not a copy.

Shapes are static: the plan's outputs and the grouped kernel's grid follow
from the pair count (rows x k) and the expert count alone (``tile_rows``,
``grid_tiles``), never from the routing, so a captured graph replays any
routing. The plan also adds (experts given a row, pairs) of every call to
a counter on the device (``stats``), which the caller owns.
"""

from __future__ import annotations

import ctypes

import torch

from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops.int4_matmul import (int4_matmul_plain,
                                                      tile_width)

_P, _I = ctypes.c_void_p, ctypes.c_int


def tile_rows(pairs: int, n_experts: int) -> int:
    """Rows a block of the grouped matmul computes: the tile route's
    width for the mean rows an expert gets (16 .. 256)."""
    return tile_width(-(-pairs // n_experts))


def grid_tiles(pairs: int, n_experts: int, t: int) -> int:
    """A bound on the token tiles any routing of ``pairs`` pairs over
    ``n_experts`` experts needs at ``t`` rows a tile: sum over the experts
    of ceil(count / t) <= ceil(pairs / t) + the experts given a row."""
    return -(-pairs // t) + min(n_experts, pairs)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def route_plain(logits: torch.Tensor, k: int, norm: bool):
    """Softmax in f32, the top k (largest first), renormalised over the
    chosen when ``norm``. Returns (ids [n, k] int32, weights [n, k] f32)."""
    p = torch.softmax(logits.float(), dim=-1)
    w, ids = torch.topk(p, k, dim=-1)
    if norm:
        w = w / w.sum(dim=-1, keepdim=True)
    return ids.to(torch.int32), w


def route(logits: torch.Tensor, k: int, norm: bool = True):
    """Router logits [n, E] f32 -> (ids [n, k] int32, weights [n, k] f32).
    CUDA: ``route_kernel`` (one warp a row, ties to the lower expert);
    CPU: ``route_plain``."""
    if not logits.is_cuda:
        return route_plain(logits, k, norm)
    logits = logits.float().contiguous()
    n, e = logits.shape
    ids = torch.empty((n, k), dtype=torch.int32, device=logits.device)
    w = torch.empty((n, k), dtype=torch.float32, device=logits.device)
    fn = _build.bind("moe_route", "tce_moe_route",
                     [_P, _I, _I, _I, _I, _P, _P, _P])
    _build.check(fn(logits.data_ptr(), n, e, k, int(norm), ids.data_ptr(),
                    w.data_ptr(), _stream(logits)), "moe_route")
    _build.LAUNCHES["moe_route"] += 1
    return ids, w


def plan_plain(ids: torch.Tensor, n_experts: int, t: int,
               stats: torch.Tensor):
    """``plan``'s arithmetic in torch: a stable sort of the pairs by
    expert."""
    flat = ids.reshape(-1).long()
    k = ids.shape[-1]
    order = torch.sort(flat, stable=True).indices
    slot_of = torch.empty_like(order)
    slot_of[order] = torch.arange(len(order), device=flat.device)
    counts = torch.zeros(n_experts, dtype=torch.long, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    zero = torch.zeros(1, dtype=torch.long, device=flat.device)
    offsets = torch.cat([zero, counts.cumsum(0)])
    tiles = torch.cat([zero, ((counts + t - 1) // t).cumsum(0)])
    stats += torch.stack([(counts > 0).sum(), counts.sum()])
    i32 = torch.int32
    return ((order // k).to(i32), slot_of.to(i32), offsets.to(i32),
            tiles.to(i32))


def plan(ids: torch.Tensor, n_experts: int, t: int, stats: torch.Tensor):
    """The pairs of ``ids`` [n, k] (pair p = row * k + j) sorted by expert,
    stably. Returns (src [n k]: the row each sorted slot reads, slot_of
    [n k]: each pair's slot, offsets [E + 1]: expert e's slots are
    offsets[e] .. offsets[e + 1], tiles [E + 1]: the scan of its token
    tiles of ``t`` rows), all int32; adds (experts given a row, pairs) to
    ``stats`` [2] int64. CUDA: ``plan_kernel`` (one block); CPU:
    ``plan_plain``."""
    if not ids.is_cuda:
        return plan_plain(ids, n_experts, t, stats)
    ids = ids.to(torch.int32).contiguous()
    n_pairs, k = ids.numel(), ids.shape[-1]
    dev = ids.device
    src = torch.empty(n_pairs, dtype=torch.int32, device=dev)
    slot_of = torch.empty(n_pairs, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_experts + 1, dtype=torch.int32, device=dev)
    tiles = torch.empty(n_experts + 1, dtype=torch.int32, device=dev)
    if stats.dtype != torch.int64 or stats.device != dev:
        raise ValueError("stats must be an int64 [2] tensor on ids' device")
    fn = _build.bind("moe_plan", "tce_moe_plan",
                     [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P])
    _build.check(fn(ids.data_ptr(), n_pairs, n_experts, k, t,
                    src.data_ptr(), slot_of.data_ptr(), offsets.data_ptr(),
                    tiles.data_ptr(), stats.data_ptr(), _stream(ids)),
                 "moe_plan")
    _build.LAUNCHES["moe_plan"] += 1
    return src, slot_of, offsets, tiles


def grouped_int4_matmul_plain(xs, packed, scales, group_size: int, e0: int,
                              offsets, n_experts: int) -> torch.Tensor:
    """Each expert's sorted rows through ``int4_matmul_plain`` (bf16
    dequantized weights, f32 sums), bf16 [P, N]."""
    y = torch.zeros((xs.shape[0], packed.shape[-1]), dtype=torch.bfloat16,
                    device=xs.device)
    off = offsets.tolist()
    for e in range(n_experts):
        a, b = off[e], off[e + 1]
        if b > a:
            y[a:b] = int4_matmul_plain(xs[a:b], packed, scales, group_size,
                                       layer_idx=e0 + e).to(torch.bfloat16)
    return y


def grouped_int4_matmul(xs, packed, scales, group_size: int, e0: int,
                        offsets, tiles, n_experts: int, t: int):
    """y [P, N] bf16: sorted row s of ``xs`` [P, K] (bf16, K the packed K)
    times the weights of its expert e (set ``e0 + e`` of ``packed`` /
    ``scales``), the experts' rows given by ``offsets``. CUDA:
    ``grouped_kernel`` at token tile ``t`` over ``grid_tiles`` row tiles,
    one launch; CPU: ``grouped_int4_matmul_plain``."""
    if not xs.is_cuda:
        return grouped_int4_matmul_plain(xs, packed, scales, group_size, e0,
                                         offsets, n_experts)
    n_sets, kh, n = packed.shape
    k = 2 * kh
    if xs.shape[-1] != k or xs.dtype != torch.bfloat16 \
            or not xs.is_contiguous() or xs.data_ptr() % 16:
        raise ValueError(f"xs must be contiguous 16-byte aligned bf16 "
                         f"[P, {k}]")
    if not (packed.is_contiguous() and scales.is_contiguous()
            and packed.dtype == torch.uint8
            and scales.dtype in (torch.bfloat16, torch.float32)
            and tuple(scales.shape) == (n_sets, k // group_size, n)):
        raise ValueError("packed / scales must be contiguous stacks "
                         "[sets, K/2, N] uint8 / [sets, K/G, N]")
    p = xs.shape[0]
    y = torch.empty((p, n), dtype=torch.bfloat16, device=xs.device)
    fn = _build.bind("int4_moe", "tce_moe_grouped",
                     [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P])
    _build.check(fn(xs.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                    int(scales.dtype == torch.bfloat16), y.data_ptr(),
                    offsets.data_ptr(), tiles.data_ptr(), p, n_experts, e0,
                    n_sets, k, n, group_size, t,
                    grid_tiles(p, n_experts, t), _stream(xs)), "int4_moe")
    _build.LAUNCHES["int4_moe"] += 1
    return y


def expert_act_plain(gu: torch.Tensor, k_pad: int) -> torch.Tensor:
    f = gu.shape[-1] // 2
    g, u = gu[:, :f].float(), gu[:, f:].float()
    act = (g / (1.0 + torch.exp(-g)) * u).to(torch.bfloat16)
    return torch.nn.functional.pad(act, (0, k_pad - f))


def expert_act(gu: torch.Tensor, k_pad: int) -> torch.Tensor:
    """gu [P, 2F] bf16 (gate | up) -> bf16(silu(g) u) [P, k_pad], silu(g)
    = g / (1 + exp(-g)) in f32, the columns past F zero (the down
    projection's packed K). CUDA: ``act_kernel``; CPU:
    ``expert_act_plain``."""
    if not gu.is_cuda:
        return expert_act_plain(gu, k_pad)
    gu = gu.contiguous()
    p, f2 = gu.shape
    act = torch.empty((p, k_pad), dtype=torch.bfloat16, device=gu.device)
    fn = _build.bind("moe_act", "tce_moe_act", [_P, _I, _I, _I, _P, _P])
    _build.check(fn(gu.data_ptr(), p, f2 // 2, k_pad, act.data_ptr(),
                    _stream(gu)), "moe_act")
    _build.LAUNCHES["moe_act"] += 1
    return act


def combine_plain(yd, slot_of, w, x) -> torch.Tensor:
    n, k = w.shape
    g = yd[slot_of.long().reshape(n, k)].float()       # [n, k, C]
    acc = torch.zeros((n, yd.shape[-1]), dtype=torch.float32,
                      device=yd.device)
    for j in range(k):
        acc = acc + w[:, j:j + 1].float() * g[:, j]
    return (x.float() + acc.to(torch.bfloat16).float()).to(torch.bfloat16)


def combine(yd, slot_of, w, x) -> torch.Tensor:
    """x + the weighted sum of each row's expert outputs: row t of the
    result is bf16(x[t] + bf16(sum_j w[t, j] yd[slot_of[t k + j]])), the
    sum in f32 in j order (a product and an add each rounded). yd [n k, C]
    bf16, slot_of [n k] int32, w [n, k] f32, x [n, C] bf16. CUDA:
    ``combine_kernel``; CPU: ``combine_plain``."""
    if not yd.is_cuda:
        return combine_plain(yd, slot_of, w, x)
    n, k = w.shape
    c = yd.shape[-1]
    yd = yd.contiguous()
    x = x.to(torch.bfloat16).contiguous()
    w = w.float().contiguous()
    out = torch.empty((n, c), dtype=torch.bfloat16, device=yd.device)
    fn = _build.bind("moe_combine", "tce_moe_combine",
                     [_P, _P, _P, _P, _I, _I, _I, _P, _P])
    _build.check(fn(yd.data_ptr(), slot_of.data_ptr(),
                    w.data_ptr(), x.data_ptr(), n, c, k, out.data_ptr(),
                    _stream(yd)), "moe_combine")
    _build.LAUNCHES["moe_combine"] += 1
    return out
