"""KV cache: one preallocated stacked buffer per K and V (counterpart of the
JAX package's ``generation/kv_cache.py``).

Layout [num_layers, batch, num_kv_heads, max_len, head_dim], the layout the
attention kernels read. Writes are IN PLACE: ``update_layer`` assigns into
the buffers and ``advance`` bumps ``length`` on the same object, which both
return for the JAX package's calling style. ``length`` is a host int (the
host always knows how many positions it has written).

bf16 (default) or int8 storage; ``quantized=True`` keeps a per-(head,
position) absmax scale in [L, B, H_kv, max_len] f32 beside the codes, while
``dtype=torch.int8`` stores raw int8 codes written and read unchanged (OPT
W8A8, whose static scales live in the attention alphas).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.ops.attention import read_cache_layer
from tinychatengine_tpu_torch.ops.ref import xla_recip


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, H_kv, S_max, D] (bf16 or int8)
    v: torch.Tensor
    length: int = 0  # number of valid positions
    k_scale: Optional[torch.Tensor] = None  # [L, B, H_kv, S_max] f32 (int8)
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(num_layers: int, batch: int, max_len: int, num_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, quantized: bool = False,
               device=None) -> KVCache:
    """Zeroed cache on ``device``; ``None`` means the card (raises without
    one), as for the port's other entry points."""
    device = resolve_device(device)
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    if quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _quantize_kv(x: torch.Tensor):
    """Per (head, position) symmetric int8: scale = absmax/127 over D, the
    division by 127 run as jitted JAX runs it (``xla_recip``).
    x [..., D] → (int8 codes, f32 scales [...])."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True)
                        * xla_recip(127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -128, 127).to(torch.int8)
    return q, scale[..., 0]


def update_layer(cache: KVCache, layer_k: torch.Tensor, layer_v: torch.Tensor,
                 layer_idx: int, start) -> KVCache:
    """Write new K/V [B, S_new, H_kv, D] into layer ``layer_idx`` (in place)
    at position ``start``: an int (every row), or an int [B] tensor on the
    cache's device (row b at start[b], the serving path's ragged write).
    Positions past max_len are dropped: they can only be bucket padding
    beyond the cache. A ragged decode write (S_new = 1) is not checked on
    the host, so its positions are the caller's to keep below max_len.
    Does not advance ``length``."""
    if isinstance(start, torch.Tensor):
        return _update_layer_rows(cache, layer_k, layer_v, layer_idx, start)
    n = min(layer_k.shape[1], cache.max_len - start)
    k = layer_k[:, :n].transpose(1, 2)  # [B, H, n, D]
    v = layer_v[:, :n].transpose(1, 2)
    sl = slice(start, start + n)
    if cache.quantized:
        qk, sk = _quantize_kv(k)
        qv, sv = _quantize_kv(v)
        cache.k[layer_idx, :, :, sl] = qk
        cache.v[layer_idx, :, :, sl] = qv
        cache.k_scale[layer_idx, :, :, sl] = sk
        cache.v_scale[layer_idx, :, :, sl] = sv
    else:
        cache.k[layer_idx, :, :, sl] = k.to(cache.k.dtype)
        cache.v[layer_idx, :, :, sl] = v.to(cache.v.dtype)
    return cache


def _update_layer_rows(cache: KVCache, layer_k, layer_v, layer_idx,
                       starts: torch.Tensor) -> KVCache:
    """Ragged write (JAX ``_update_layer_per_slot``): row b of
    [B, S_new, H, D] lands at positions starts[b] + s, as one indexed
    assignment per buffer (no loop over rows)."""
    b, s = layer_k.shape[:2]
    rows = torch.arange(b, device=starts.device)[:, None].expand(b, s)
    pos = starts.long()[:, None] + torch.arange(s, device=starts.device)
    k, v = layer_k, layer_v
    # bucket padding may reach past the cache: drop it (a host read, so a
    # captured write, a speculative verify, keeps its positions in the
    # cache itself)
    if s > 1 and not (k.is_cuda and torch.cuda.is_current_stream_capturing()):
        keep = pos < cache.max_len
        if not bool(keep.all()):
            rows, pos, k, v = rows[keep], pos[keep], k[keep], v[keep]
    # advanced indices around a slice put their dims first: the target
    # cache.k[layer][rows, :, pos] is [B, S_new, H, D], the layout of k
    if cache.quantized:
        qk, sk = _quantize_kv(k)  # per (position, head) over D
        qv, sv = _quantize_kv(v)
        cache.k[layer_idx][rows, :, pos] = qk
        cache.v[layer_idx][rows, :, pos] = qv
        cache.k_scale[layer_idx][rows, :, pos] = sk
        cache.v_scale[layer_idx][rows, :, pos] = sv
    else:
        cache.k[layer_idx][rows, :, pos] = k.to(cache.k.dtype)
        cache.v[layer_idx][rows, :, pos] = v.to(cache.v.dtype)
    return cache


def read_layer(cache: KVCache, layer_idx: int):
    """Full-length K/V [B, H_kv, S_max, D] of one layer, int8 dequantized to
    bf16; positions past ``length`` must be masked by the consumer."""
    return read_cache_layer(cache.k, cache.v, layer_idx, cache.k_scale,
                            cache.v_scale)


def advance(cache: KVCache, n: int) -> KVCache:
    cache.length += int(n)
    return cache


def _buffers(cache: KVCache) -> tuple:
    return tuple(t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
                 if t is not None)


def layout(cache: KVCache) -> tuple:
    """(shape, dtype, device) of each buffer: caches of one layout can
    take each other's positions (``copy_positions``)."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in _buffers(cache))


def fresh_like(cache: KVCache) -> KVCache:
    """A cache of ``cache``'s layout as ``init_cache`` makes one (zero
    codes, unit scales), length 0."""
    ones = (None if t is None else torch.ones_like(t)
            for t in (cache.k_scale, cache.v_scale))
    return KVCache(torch.zeros_like(cache.k), torch.zeros_like(cache.v), 0,
                   *ones)


def clone(cache: KVCache) -> KVCache:
    """A copy of ``cache`` (every buffer and its length)."""
    return KVCache(cache.k.clone(), cache.v.clone(), cache.length,
                   *(None if t is None else t.clone()
                     for t in (cache.k_scale, cache.v_scale)))


def copy_positions(src: KVCache, dst: KVCache, lo: int, hi: int) -> KVCache:
    """Positions [lo, hi) of every layer, row and head (codes and scales)
    from ``src`` into ``dst`` of the same layout, in place; ``length`` is
    the caller's."""
    hi = min(hi, dst.max_len)
    if hi > lo:
        for s, d in zip(_buffers(src), _buffers(dst)):
            d[:, :, :, lo:hi].copy_(s[:, :, :, lo:hi])
    return dst
