"""Fused dequant-INT4 matmuls: W4A16 (``int4_matmul``), its K-outer route
for small M (``int4_matmul_kouter``), W4A8 (``int4_matmul_a8``), the
decode matmul with its norm, RoPE, bias and residual folded in
(``int4_matmul_fused``) and the down projection with silu(gate) * up folded
in (``int4_matmul_glu``), with their plain PyTorch versions.

Counterpart of the JAX package's ``ops/int4_matmul.py``. The kernels are
``csrc/int4_matmul.cu``, ``csrc/int4_matmul_kouter.cu`` (K-outer and GLU),
``csrc/int4_matmul_a8.cu`` and ``csrc/int4_matmul_fused.cu``. They read the
QM_TPU packed layout as stored (``quant/packing.py``): ``packed [K/2, N]``
uint8, or layer-stacked ``[L, K/2, N]`` with ``layer_idx`` selecting the
layer by a pointer offset (no per-layer copy); ``scales [K/G, N]`` (or
``[L, K/G, N]``) in bf16 or f32. A pack-padded K (``packing.padded_ic``) is
handled by zero-padding x: the pad rows hold the zero-point code and
dequantize to 0.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain version. ``int4_matmul`` on the card takes one of three routes
(``int4_route``): the K-outer kernel where ``DECODE_KOUTER`` lists the
call; else, from M alone, the band route at M <= 8 (the split-K band
contraction the K-outer kernel runs, memory-bound) or the tile route at
M >= 9: wgmma with the dequantized weights as its register-fed A operand
and a token tile of x's rows (16 to 256, ``tile_width``) as its n, so it
is bound by the weight bytes at a 16-row decode tick and by the
operations at a 512-row chunk (two 256-row tiles), K split over a
cluster from K and N alone (``tile_split``); the cast point is
bf16((q - 8) * d) with f32 sums, the plain version's. Within a route an
output row's bits depend on its x row alone; the routes' cast points
differ, so across M = 8 / 9 they do not. The plain versions keep the JAX
fallbacks' cast points (``int4_matmul_xla`` / ``int4_matmul_a8_xla``); the
fused one follows the TPU kernel's body (``_fused_kernel``) instead.

``FUSED_DECODE`` is the fused decode switch (the JAX package's flag of the
same name): the model forwards read it at call time and, when it is on, run
their one-token steps through ``int4_matmul_fused``. Off by default, as in
JAX; the environment variable ``TINYCHAT_DECODE_FUSED=1`` turns it on at
import, and code may set the attribute at any time.

``int4_matmul_kouter``, ``int4_matmul_fused`` and ``int4_matmul_glu`` run
the tensor-core contraction of ``csrc/int4_mma.cuh`` at every row count
(exact codes q - 8 in bf16, mma.sync into a per-group f32 sum folded with
its f32 scale, the TPU kernels' cast point; a block covers
``mma_row_tile(M)`` rows), so a row's bits do not depend on how many rows
ride along. ``int4_matmul_a8``
runs the TPU kernel's W4A8 arithmetic on the int8 tensor cores (exact
int32 group dots by mma.sync m16n8k32, the same row tiles, a K split
from K and N alone: ``a8_split``), with the same property.

``DECODE_KOUTER`` is the K-outer route's table (the JAX package's table of
the same name), ``(K, N) -> (block_n, block_k)`` with K the packed K: a
stacked CUDA call of ``int4_matmul`` at fewer than 512 (16-padded) rows
whose shape is listed runs ``int4_matmul_kouter`` with the listed K band.
Empty by default; ``TINYCHAT_DECODE_KOUTER="K,N:bn,bk;..."`` fills it at
import, and code may fill it at any time. A CPU call ignores it.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops.ref import (ZERO_POINT, dequantize_int4,
                                              unpack_int4, xla_recip)
from tinychatengine_tpu_torch.quant.packing import PLANE, SUPERBLOCK

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

FUSED_DECODE = os.environ.get("TINYCHAT_DECODE_FUSED", "0") not in ("", "0")

# (K, N) -> (block_n, block_k): stacked shapes routed through the K-outer
# kernel below 512 rows (see the module docstring)
DECODE_KOUTER: dict = {}


def _parse_env_blocks(table: dict | None = None) -> dict:
    """Fills ``table`` (``DECODE_KOUTER`` by default) from the environment
    variable ``TINYCHAT_DECODE_KOUTER``: ``"K,N:block_n,block_k;..."``,
    where block_n divides N and is a multiple of 128 and block_k divides K
    and is a multiple of ``SUPERBLOCK`` (the JAX package's syntax and
    refusals). Raises ``ValueError`` on a malformed entry."""
    table = DECODE_KOUTER if table is None else table
    env = "TINYCHAT_DECODE_KOUTER"
    for item in os.environ.get(env, "").split(";"):
        if not item.strip():
            continue
        try:
            shape, blocks = item.split(":")
            k, n = (int(v) for v in shape.split(","))
            bn, bk = (int(v) for v in blocks.split(","))
        except ValueError as e:
            raise ValueError(
                f"{env} entry {item!r} malformed (want "
                f"'K,N:block_n,block_k;...'): {e}") from None
        if n % bn or k % bk or bk % SUPERBLOCK or bn % 128:
            raise ValueError(
                f"{env} {item!r}: block_n must divide N and be a multiple "
                f"of 128; block_k must divide K and be a multiple of "
                f"{SUPERBLOCK}")
        table[(k, n)] = (bn, bk)
    return table


_parse_env_blocks()


def kouter_route(m: int, kw: int, n: int, stacked: bool):
    """The (block_n, block_k) of ``DECODE_KOUTER`` that a CUDA call of
    ``int4_matmul`` at ``m`` rows, packed K ``kw`` and ``n`` columns runs
    the K-outer kernel with, or None: the JAX package's gate (stacked
    weights, fewer than 512 rows after padding M to 16, a listed shape)."""
    if stacked and m + (-m) % 16 < 512:
        return DECODE_KOUTER.get((kw, n))
    return None


def mma_row_tile(m: int) -> int:
    """Rows one block of the K-outer and fused kernels' tensor-core
    contraction covers at ``m`` rows (the C side's ``row_tile``): 8, 16,
    32, or 64 with the rest as grid rows."""
    return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64


def _mma_operand(x2, w_ptr, s_ptr, n):
    """The tensor-core kernels copy x, weights and scales 16 bytes at a
    time: checks N % 16 == 0 and the weight and scale pointers' alignment,
    and returns x2 at a 16-byte aligned address (a copy where it is not)."""
    if n % 16 or (w_ptr | s_ptr) % 16:
        raise ValueError(f"the tensor-core kernels need N % 16 == 0 and "
                         f"16-byte aligned weights and scales; got N={n}")
    return x2.clone() if x2.data_ptr() % 16 else x2


# rows at and below which a CUDA call of int4_matmul takes the band route;
# above, the tile route (the kernel takes the choice as ``bands``)
BAND_MAX_ROWS = 8
# the band route splits K until about this many blocks stream the weight
# (two per SM of the H100's 132)
_BAND_TARGET_BLOCKS = 264


def band_split(kw: int, n: int) -> tuple[int, int]:
    """(superblocks per band, bands) of the band route for packed K ``kw``
    and ``n`` columns: from K and N alone, never from M, so that a row's
    bits do not depend on how many rows ride along."""
    nsb = kw // SUPERBLOCK
    tiles = -(-n // 128)
    want = max(1, min(nsb, -(-_BAND_TARGET_BLOCKS // tiles)))
    per = nsb // want  # at least ``want`` bands
    return per, -(-nsb // per)


# the tile route's token-tile widths (wgmma's n, rows of x a block
# computes; rows past M are zero-filled), the weight columns a block (two
# warpgroups of wgmma's 64), the most blocks a K split spans (one cluster)
# and the blocks its split aims at at decode widths (two per SM)
TILE_WIDTHS = (16, 32, 64, 128, 256)
TILE_COLS = 128
TILE_MAX_SPLIT = 8
_TILE_TARGET_BLOCKS = 264


def tile_width(m: int) -> int:
    """Rows a block of the tile route computes at ``m`` rows, passed to the
    kernel (which makes no choice of its own): the smallest of
    ``TILE_WIDTHS`` that holds them, and 256-row tiles above."""
    return next((w for w in TILE_WIDTHS if w >= m), TILE_WIDTHS[-1])


def tile_split(kw: int, n: int) -> int:
    """Blocks (one cluster) the tile route splits packed K ``kw`` over at
    ``n`` columns: the largest power of two that keeps the blocks over
    the column tiles within ``_TILE_TARGET_BLOCKS``, at most
    ``TILE_MAX_SPLIT``, at least two 128-k stages a block (on the H100,
    StarCoder's c_proj and fc_out at 16 rows ran 0.0173 and 0.0545 ms
    split 4, 0.0236 and 0.0696 split 5, 0.0372 and 0.1368 unsplit).
    From K and N alone, never from M, so that a row's bits do not depend
    on how many rows ride along."""
    tiles = -(-n // TILE_COLS)
    most = min(TILE_MAX_SPLIT, kw // 256, _TILE_TARGET_BLOCKS // tiles)
    return 1 << (max(1, most).bit_length() - 1)


def int4_route(m: int, kw: int, n: int, stacked: bool):
    """The route a CUDA call of ``int4_matmul`` at ``m`` rows, packed K
    ``kw`` and ``n`` columns takes: ``("kouter", (block_n, block_k))``
    where ``kouter_route`` lists it; else ``("band", (superblocks per band,
    bands))`` at M <= ``BAND_MAX_ROWS``, stacked or not; else
    ``("tile", (token-tile width, K split))``."""
    blocks = kouter_route(m, kw, n, stacked)
    if blocks is not None:
        return "kouter", blocks
    if m <= BAND_MAX_ROWS:
        return "band", band_split(kw, n)
    return "tile", (tile_width(m), tile_split(kw, n))


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


def _cuda_weights(x, packed, scales, group_size, layer_idx):
    """The kernels' checks of the weights; returns the layer's weight and
    scale pointers (a stacked layer is a pointer offset, not a copy)."""
    kw, n = 2 * packed.shape[-2], packed.shape[-1]
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
    li = 0 if layer_idx is None else int(layer_idx)
    w_ptr = packed.data_ptr() + li * (kw // 2) * n
    s_ptr = scales.data_ptr() + li * (kw // group_size) * n * scales.element_size()
    return w_ptr, s_ptr


def _cuda_args(x, packed, scales, group_size, layer_idx):
    """Checks shared by the kernels; returns the 2-D zero-padded bf16 x,
    the layer's weight and scale pointers and the shape numbers."""
    k, kw, n = _check_layout(x, packed, scales, group_size, layer_idx)
    w_ptr, s_ptr = _cuda_weights(x, packed, scales, group_size, layer_idx)
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if kw > k:
        x2 = torch.nn.functional.pad(x2, (0, kw - k))
    return x2.contiguous(), w_ptr, s_ptr, kw, n


def factored_int4(xb: torch.Tensor, packed: torch.Tensor,
                  scales: torch.Tensor, group_size: int,
                  split_zero_point: bool = False) -> torch.Tensor:
    """The TPU kernels' dequant contraction of one layer, f32 [M, N]: per
    group g, with the exact codes q and f32 scales d, ``(x . q - 8 sum x)
    * d`` (or ``(x . q) * d - (8 sum x) * d`` with ``split_zero_point``, as
    ``mlp_fused``'s kernel writes it), summed over the groups. ``xb`` is
    bf16 [M, K] with K the packed K."""
    m, k = xb.shape
    n, ng = packed.shape[-1], k // group_size
    xg = xb.float().reshape(m, ng, group_size)
    codes = unpack_int4(packed).float().reshape(ng, group_size, n)
    dot = torch.einsum("mgk,gkn->mgn", xg, codes)
    xsum8 = xg.sum(dim=-1, keepdim=True) * ZERO_POINT
    d = scales.float()[None]
    terms = dot * d - xsum8 * d if split_zero_point else (dot - xsum8) * d
    return terms.sum(dim=1)


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
    """y[..., N] = x[..., K] @ ((q - 8) * d), bf16 out. CUDA
    (``int4_route``): the K-outer kernel where ``kouter_route`` lists the
    call, else ``csrc/int4_matmul.cu``: the band route at M <= 8 (split-K
    bands of whole superblocks, exact codes times f32 scales, band sums in
    K order), the tile route at M >= 9 (wgmma with bf16((q - 8) * d) as
    the register A operand over ``tile_width(M)`` rows of x, K split over
    ``tile_split`` blocks of a cluster, split sums in K order; each launch
    counted by width in ``_build.TILE_LAUNCHES``); CPU:
    ``int4_matmul_plain``."""
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scales, group_size,
                                 layer_idx=layer_idx)
    route, arg = int4_route(x.numel() // x.shape[-1], 2 * packed.shape[-2],
                            packed.shape[-1], layer_idx is not None)
    if route == "kouter":
        return int4_matmul_kouter(x, packed, scales, group_size,
                                  layer_idx=layer_idx, block_n=arg[0],
                                  block_k=arg[1])
    x2, w_ptr, s_ptr, kw, n = _cuda_args(x, packed, scales, group_size,
                                         layer_idx)
    if x2.data_ptr() % 16:  # TMA reads x from a 16-byte aligned address
        x2 = x2.clone()
    m = x2.shape[0]
    # the tile route passes its K split where the band route passes its
    # superblocks per band, and minus its token tile as the bands (a
    # negative count selects the route; the kernel launched is the one
    # counted)
    per, bands = arg if route == "band" else (arg[1], -arg[0])
    part = torch.empty((bands, m, n) if bands > 0 else (1,),
                       dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    fn = _build.bind("int4_matmul", "tce_int4_matmul",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P])
    _build.check(fn(x2.data_ptr(), w_ptr, s_ptr, y.data_ptr(), m, kw, n,
                    group_size, int(scales.dtype == torch.bfloat16),
                    part.data_ptr(), per, bands,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "int4_matmul")
    _build.LAUNCHES["int4_matmul"] += 1
    if route == "tile":
        _count_tile(arg[0])
    return y.reshape(*x.shape[:-1], n)


def _count_tile(width: int) -> None:
    """One launch of the tile route at token-tile ``width``."""
    _build.TILE_LAUNCHES[width] = _build.TILE_LAUNCHES.get(width, 0) + 1


def a8_quantize_plain(x2: torch.Tensor, group_size: int):
    """The W4A8 activation quantizer of ``int4_matmul_a8_xla``: per row and
    group of f32 x [M, K], a_scale = max(absmax, 1e-8) / 127 (the division
    as jitted JAX runs it, ``xla_recip``) and q_a = clip(round(x /
    a_scale), -127, 127), half to even. Returns (q_a [M, K/G, G] f32,
    a_scale [M, K/G, 1] f32)."""
    m, k = x2.shape
    g = x2.reshape(m, k // group_size, group_size)
    absmax = g.abs().amax(dim=-1, keepdim=True)
    a_scale = torch.clamp(absmax, min=1e-8) * xla_recip(127.0)
    return torch.clamp(torch.round(g / a_scale), -127, 127), a_scale


def int4_matmul_a8_plain(x, packed, scales, group_size: int = 128, *,
                         layer_idx=None) -> torch.Tensor:
    """Fake-quantized int8 activations (``a8_quantize_plain``) times the
    f32-dequantized weights, bf16 out (``int4_matmul_a8_xla``)."""
    k, _, _ = _check_layout(x, packed, scales, group_size, layer_idx)
    x2 = x.reshape(-1, k).float()
    q_a, a_scale = a8_quantize_plain(x2, group_size)
    xq = (q_a * a_scale).reshape(x2.shape)
    w = dequantize_int4(_layer(packed, layer_idx), _layer(scales, layer_idx),
                        group_size, torch.float32)[:k]
    y = torch.matmul(xq, w)
    return y.to(torch.bfloat16).reshape(*x.shape[:-1], -1)


# the W4A8 kernel splits K until about this many blocks are launched (one
# an SM of the H100's 132: more ran slower at 64 rows, where two 64-row
# blocks fill an SM, and at 1-8 rows gained only at down; PERF.md), in at
# most A8_MAX_BANDS bands: a tile's bands form one thread-block cluster (8
# is the portable size)
_A8_TARGET_BLOCKS = 132
A8_MAX_BANDS = 8


def a8_split(kw: int, n: int) -> tuple[int, int]:
    """(superblocks per band, bands) of ``int4_matmul_a8``'s kernel for
    packed K ``kw`` and ``n`` columns: from K and N alone, never from M,
    so a row's bits do not depend on how many rows ride along."""
    nsb = kw // SUPERBLOCK
    tiles = -(-n // 128)
    want = max(1, min(nsb, A8_MAX_BANDS, -(-_A8_TARGET_BLOCKS // tiles)))
    per = -(-nsb // want)
    return per, -(-nsb // per)


def int4_matmul_a8(x, packed, scales, group_size: int = 128, *,
                   layer_idx=None) -> torch.Tensor:
    """W4A8: activations quantized to int8 per (row, group) at run time,
    exact int32 group dots. CUDA: ``csrc/int4_matmul_a8.cu`` (a quantize
    kernel, then mma.sync m16n8k32 on the int8 tensor cores over blocks of
    128 columns and ``mma_row_tile(M)`` rows, K split by ``a8_split`` with
    a tile's bands summed in K order inside one cluster); CPU:
    ``int4_matmul_a8_plain``."""
    if not x.is_cuda:
        return int4_matmul_a8_plain(x, packed, scales, group_size,
                                    layer_idx=layer_idx)
    x2, w_ptr, s_ptr, kw, n = _cuda_args(x, packed, scales, group_size,
                                         layer_idx)
    _mma_operand(x2, w_ptr, s_ptr, n)
    m, dev = x2.shape[0], x.device
    per, bands = a8_split(kw, n)
    qa = torch.empty((m, kw), dtype=torch.int8, device=dev)
    aux = torch.empty((m, kw // group_size, 2), dtype=torch.int32, device=dev)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    fn = _build.bind("int4_matmul_a8", "tce_int4_matmul_a8",
                     [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    _build.check(fn(x2.data_ptr(), w_ptr, s_ptr,
                    int(scales.dtype == torch.bfloat16), qa.data_ptr(),
                    aux.data_ptr(), y.data_ptr(), m, kw, n, group_size, per,
                    bands, torch.cuda.current_stream(dev).cuda_stream),
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
    y = factored_int4(xn, packed[li], scales[li], group_size).to(
        torch.bfloat16)
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


# int4_matmul_fused's blocks are light (128 threads, four share an SM): it
# splits K until about eight blocks per SM are launched
_MMA_TARGET_BLOCKS = 1056


def split_k(units: int, tiles: int, target: int) -> tuple[int, int]:
    """(K units per band, bands) of a split-K grid of ``tiles`` output
    tiles over ``units`` K units (superblocks, or int3's 1024-row chunks),
    until about ``target`` blocks are launched: whole units, the last band
    at least one."""
    want = max(1, min(units, -(-target // tiles)))
    per = -(-units // want)
    return per, -(-units // per)


def fused_kernel_split(m: int, n: int, k: int) -> tuple[int, int]:
    """(superblocks per split, splits) of ``int4_matmul_fused``'s kernel at
    ``m`` rows (the tiles counted as 128 columns by 8 rows, 1 at M = 1): a
    function of K and N alone at M <= 8, so a serving row's bits do not
    depend on how many slots are active."""
    tiles = -(-n // 128) * -(-m // (1 if m == 1 else 8))
    return split_k(k // SUPERBLOCK, tiles, _MMA_TARGET_BLOCKS)


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
    tiling and interpret mode). CUDA: ``csrc/int4_matmul_fused.cu`` (the
    norm by a first kernel into a bf16 [M, K] workspace, the tensor-core
    contraction split over K by ``fused_kernel_split``, the epilogues);
    CPU: ``int4_matmul_fused_plain``."""
    args = dict(layer_idx=layer_idx, norm_w=norm_w, norm_b=norm_b,
                norm_eps=norm_eps, rope_cos=rope_cos, rope_sin=rope_sin,
                rope_qk_cols=rope_qk_cols, head_dim=head_dim, bias=bias,
                residual=residual)
    if not x.is_cuda:
        return int4_matmul_fused_plain(x, packed, scales, group_size, **args)
    packed, scales, li, norm_w, norm_b, bias = _fused_operands(
        x, packed, scales, group_size, layer_idx, norm_w, norm_b, bias)
    x2, w_ptr, s_ptr, k, n = _cuda_args(x, packed, scales, group_size, li)
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
    x2 = _mma_operand(x2, w_ptr, s_ptr, n)
    per, ksplit = fused_kernel_split(m, n, k)
    xn = None
    if norm_w is not None:
        xn = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((ksplit, m, n), dtype=torch.float32, device=dev)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    fn = _build.bind("int4_matmul_fused", "tce_int4_matmul_fused",
                     [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P, _I, _P, _I, _F, _P, _P, _I, _I, _P, _I, _P, _P, _P])
    _build.check(fn(x2.data_ptr(), w_ptr, s_ptr,
                    int(scales.dtype == torch.bfloat16), partial.data_ptr(),
                    y.data_ptr(), m, k, n, group_size, per, ksplit,
                    nw_ptr, nw_bf16, nb_ptr, nb_bf16, float(norm_eps),
                    None if cos is None else cos.data_ptr(),
                    None if sin is None else sin.data_ptr(), qk_cols,
                    int(head_dim), b_ptr, b_bf16,
                    None if res is None else res.data_ptr(),
                    None if xn is None else xn.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream),
                 "int4_matmul_fused")
    _build.LAUNCHES["int4_matmul_fused"] += 1
    return y.reshape(*x.shape[:-1], n)


def _check_kouter(packed, group_size, layer_idx, block_n, block_k):
    """Checks of a K-outer call beyond the layout's (the asserts of JAX's
    ``_int4_matmul_kouter``, as ValueError): stacked weights, K/G a
    multiple of 8, block_n dividing N in multiples of 128, block_k dividing
    the packed K in superblocks."""
    if packed.dim() != 3 or layer_idx is None:
        raise ValueError("the K-outer kernel takes stacked weights "
                         "[L, K/2, N] with layer_idx")
    kw, n = 2 * packed.shape[-2], packed.shape[-1]
    if (kw // group_size) % 8:
        raise ValueError(f"the K-outer kernel needs K/G % 8 == 0, got "
                         f"K={kw}, G={group_size}")
    if n % block_n or block_n % 128 or kw % block_k or block_k % SUPERBLOCK:
        raise ValueError(
            f"block_n {block_n} must divide N={n} in multiples of 128 and "
            f"block_k {block_k} divide K={kw} in multiples of {SUPERBLOCK}")


def int4_matmul_kouter_plain(x, packed, scales, group_size: int = 128, *,
                             layer_idx, block_n: int,
                             block_k: int) -> torch.Tensor:
    """The TPU kernel's arithmetic (``_kouter_kernel``): x in bf16, exact
    codes, f32 scales, per group ``acc += (x . q - 8 sum x) * d`` in f32,
    the result rounded to bf16 once. The blocking changes nothing here."""
    k, kw, n = _check_layout(x, packed, scales, group_size, layer_idx)
    _check_kouter(packed, group_size, layer_idx, block_n, block_k)
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if kw > k:
        x2 = torch.nn.functional.pad(x2, (0, kw - k))
    li = int(layer_idx)
    y = factored_int4(x2, packed[li], scales[li], group_size)
    return y.to(torch.bfloat16).reshape(*x.shape[:-1], n)


def int4_matmul_kouter(x, packed, scales, group_size: int = 128, *,
                       layer_idx, block_n: int,
                       block_k: int) -> torch.Tensor:
    """y[..., N] = x[..., K] @ ((q - 8) * d) over stacked weights, bf16
    out, with K walked in bands of ``block_k`` rows (the K-outer kernel,
    the JAX package's ``_int4_matmul_kouter``). CUDA:
    ``csrc/int4_matmul_kouter.cu``: one block per (128 columns,
    ``mma_row_tile(M)`` rows, K band) on the tensor cores, f32 band sums
    summed in K order by a second kernel; CPU:
    ``int4_matmul_kouter_plain``. ``block_n`` is checked as JAX checks it
    (the table's syntax and refusals stay JAX's) and otherwise ignored: the
    kernel tiles N in 128 columns whatever it is."""
    if not x.is_cuda:
        return int4_matmul_kouter_plain(x, packed, scales, group_size,
                                        layer_idx=layer_idx, block_n=block_n,
                                        block_k=block_k)
    x2, w_ptr, s_ptr, kw, n = _cuda_args(x, packed, scales, group_size,
                                         layer_idx)
    _check_kouter(packed, group_size, layer_idx, block_n, block_k)
    m, dev = x2.shape[0], x.device
    bands = kw // block_k
    x2 = _mma_operand(x2, w_ptr, s_ptr, n)
    partial = torch.empty((bands, m, n), dtype=torch.float32, device=dev)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    fn = _build.bind("int4_matmul_kouter", "tce_int4_matmul_kouter",
                     [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    _build.check(fn(x2.data_ptr(), w_ptr, s_ptr,
                    int(scales.dtype == torch.bfloat16), partial.data_ptr(),
                    y.data_ptr(), m, kw, n, group_size,
                    block_k // SUPERBLOCK, bands,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "int4_matmul_kouter")
    _build.LAUNCHES["int4_matmul_kouter"] += 1
    return y.reshape(*x.shape[:-1], n)


def _glu_operands(gu, packed, scales, group_size, layer_idx):
    """Checks of a GLU call (the JAX wrapper's tiling, as ValueError):
    gu [..., 2F] with F a multiple of ``SUPERBLOCK``, stacked down weights
    [L, F/2, N] (no pack pad) with N a multiple of 128. Returns (F, N)."""
    f2 = gu.shape[-1]
    f = f2 // 2
    if packed.dim() != 3 or layer_idx is None:
        raise ValueError("int4_matmul_glu takes stacked down weights "
                         "[L, F/2, N] with layer_idx")
    if f2 % 2 or f % SUPERBLOCK or 2 * packed.shape[-2] != f:
        raise ValueError(f"gu [..., {f2}] does not fit packed "
                         f"{tuple(packed.shape)}: want gu [..., 2F] with F "
                         f"= packed K a multiple of {SUPERBLOCK}")
    _, _, n = _check_layout(gu[..., :f], packed, scales, group_size,
                            layer_idx)
    if n % 128:
        raise ValueError(f"int4_matmul_glu needs N % 128 == 0, got N={n}")
    return f, n


def int4_matmul_glu_plain(gu, packed, scales, group_size: int = 128, *,
                          layer_idx) -> torch.Tensor:
    """The TPU kernel's arithmetic (``_glu_kernel``): gate and up rounded
    to bf16, ``act = bf16(sigmoid(g) * g * u)`` in f32, then the factored
    contraction against layer ``layer_idx`` of W_down (``factored_int4``),
    rounded to bf16 once."""
    f, n = _glu_operands(gu, packed, scales, group_size, layer_idx)
    g2 = gu.reshape(-1, 2 * f).to(torch.bfloat16).float()
    gate, up = g2[:, :f], g2[:, f:]
    act = (torch.sigmoid(gate) * gate * up).to(torch.bfloat16)
    li = int(layer_idx)
    y = factored_int4(act, packed[li], scales[li], group_size)
    return y.to(torch.bfloat16).reshape(*gu.shape[:-1], n)


# the GLU kernel splits F until about this many blocks are launched: at
# 8-row tiles as ``int4_matmul_fused`` (four blocks share an SM), at larger
# row tiles about two an SM, since the f32 band sums grow with the rows
_GLU_TARGET_BLOCKS = _MMA_TARGET_BLOCKS
_GLU_TARGET_BLOCKS_WIDE = 264


def glu_split(m: int, n: int, f: int) -> tuple[int, int]:
    """(superblocks per band, bands) of ``int4_matmul_glu``'s contraction
    at ``m`` rows, F = ``f`` and ``n`` columns over blocks of 128 columns
    and ``mma_row_tile(m)`` rows: a function of F and N alone up to 8 rows
    (one row tile), so a serving row's bits do not depend on how many
    slots are active."""
    tile = mma_row_tile(m)
    target = _GLU_TARGET_BLOCKS if tile == 8 else _GLU_TARGET_BLOCKS_WIDE
    return split_k(f // SUPERBLOCK, -(-n // 128) * -(-m // tile), target)


def int4_matmul_glu(gu, packed, scales, group_size: int = 128, *,
                    layer_idx) -> torch.Tensor:
    """y = silu(gu[..., :F]) * gu[..., F:] @ ((q - 8) * d) with W_down
    stacked [L, F/2, N] at ``layer_idx``; gu is the fused gate_up output
    [..., 2F]. Returns [..., N] bf16 (the JAX package's signature). CUDA:
    ``csrc/int4_matmul_kouter.cu``: a first kernel makes the bf16
    activation [M, F] once in device memory, then the K-outer kernel's
    tensor-core contraction runs on it, F split by ``glu_split``, the bands
    added in K order; CPU: ``int4_matmul_glu_plain``."""
    if not gu.is_cuda:
        return int4_matmul_glu_plain(gu, packed, scales, group_size,
                                     layer_idx=layer_idx)
    f, n = _glu_operands(gu, packed, scales, group_size, layer_idx)
    w_ptr, s_ptr = _cuda_weights(gu, packed, scales, group_size, layer_idx)
    g2 = gu.reshape(-1, 2 * f).to(torch.bfloat16).contiguous()
    g2 = _mma_operand(g2, w_ptr, s_ptr, n)
    m, dev = g2.shape[0], gu.device
    per, bands = glu_split(m, n, f)
    act = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((bands, m, n), dtype=torch.float32, device=dev)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    fn = _build.bind("int4_matmul_glu", "tce_int4_matmul_glu",
                     [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    _build.check(fn(g2.data_ptr(), w_ptr, s_ptr,
                    int(scales.dtype == torch.bfloat16), act.data_ptr(),
                    partial.data_ptr(), y.data_ptr(), m, f, n, group_size,
                    per, bands, torch.cuda.current_stream(dev).cuda_stream),
                 "int4_matmul_glu")
    _build.LAUNCHES["int4_matmul_glu"] += 1
    return y.reshape(*gu.shape[:-1], n)
