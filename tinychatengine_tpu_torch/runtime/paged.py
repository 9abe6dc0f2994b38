"""Paged KV cache: block-table memory for serving (counterpart of the JAX
package's ``runtime/paged.py``).

- KV storage is a pool of fixed-size pages [L, n_pages, H_kv, page, D];
- each sequence owns a list of pages (a ``page_table`` row); pages are
  allocated as sequences grow and recycled when a request finishes;
- ``ops/attention.py flash_decode_paged`` resolves each key's page through
  the table inside its kernel;
- page allocation is host-side (a free list).

Writes are IN PLACE, as in ``generation/kv_cache.py``: each write is one
indexed assignment per buffer into the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation.kv_cache import _quantize_kv
from tinychatengine_tpu_torch.ops.attention import gather_pages
from tinychatengine_tpu_torch.quant.packing import numpy_to_torch


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor  # [L, n_pages, H_kv, page, D] (bf16 or int8)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [L, n_pages, H_kv, page] f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_cache(num_layers: int, n_pages: int, num_kv_heads: int,
                     page_size: int, head_dim: int, dtype=torch.bfloat16,
                     quantized: bool = False, device=None) -> PagedKVCache:
    """Zeroed page pool on ``device``; ``None`` means the card (raises
    without one)."""
    device = resolve_device(device)
    shape = (num_layers, n_pages, num_kv_heads, page_size, head_dim)
    if quantized:
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device))
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def paged_cache_from_numpy(k, v, k_scale=None, v_scale=None,
                           device=None) -> PagedKVCache:
    """A page pool from numpy arrays (a JAX ``PagedKVCache``'s leaves taken
    with ``np.asarray``; bf16 arrives as 2-byte void and is read as bf16
    bits) on ``device`` (``None``: the card)."""
    dev = resolve_device(device)

    def leaf(a):
        return None if a is None else numpy_to_torch(a).to(dev)

    return PagedKVCache(k=leaf(k), v=leaf(v), k_scale=leaf(k_scale),
                        v_scale=leaf(v_scale))


class PageAllocator:
    """Host-side page free list (one per PagedKVCache)."""

    def __init__(self, n_pages: int, page_size: int, max_pages_per_seq: int):
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self._free = list(range(n_pages - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV: need {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        self._free.extend(int(p) for p in pages)


def paged_update_layer(cache: PagedKVCache, layer_k, layer_v, layer_idx: int,
                       lengths: torch.Tensor,
                       page_table: torch.Tensor) -> PagedKVCache:
    """Decode-step write (in place): new K/V [B, 1, H_kv, D] land at each
    sequence's position lengths[b], in page page_table[b, lengths[b] // P]
    at offset lengths[b] % P. Inactive rows all point at one dead page and
    may write the same place there; which of them lands is immaterial."""
    p = cache.page_size
    lengths = lengths.long()
    page_ids = page_table.long().gather(1, (lengths // p)[:, None])[:, 0]
    offs = lengths % p
    # advanced indices around a slice put their dims first: the target
    # buf[layer][page_ids, :, offs] is [B, H, D], the layout of k[:, 0]
    k, v = layer_k[:, 0], layer_v[:, 0]
    if cache.quantized:
        qk, sk = _quantize_kv(k)
        qv, sv = _quantize_kv(v)
        cache.k[layer_idx][page_ids, :, offs] = qk
        cache.v[layer_idx][page_ids, :, offs] = qv
        cache.k_scale[layer_idx][page_ids, :, offs] = sk
        cache.v_scale[layer_idx][page_ids, :, offs] = sv
    else:
        cache.k[layer_idx][page_ids, :, offs] = k.to(cache.k.dtype)
        cache.v[layer_idx][page_ids, :, offs] = v.to(cache.v.dtype)
    return cache


def insert_prefix(cache: PagedKVCache, scratch_k, scratch_v,
                  page_ids: torch.Tensor, scratch_k_scale=None,
                  scratch_v_scale=None) -> PagedKVCache:
    """Splice a contiguous prefill result into allocated pages (in place).

    scratch_k/v: [L, H, S_bucket, D] (one sequence's prefix, S_bucket a
    multiple of the page size); page_ids: [n] int tensor on the pool's
    device with n = S_bucket // page_size. One indexed assignment per
    buffer."""
    L, H, S, D = scratch_k.shape
    p = cache.page_size
    n = S // p
    ids = page_ids.long()

    def pages(x):  # [L, H, n*p, ...] -> [L, n, H, p, ...]
        return x.reshape(L, H, n, p, *x.shape[3:]).transpose(1, 2)

    cache.k[:, ids] = pages(scratch_k).to(cache.k.dtype)
    cache.v[:, ids] = pages(scratch_v).to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[:, ids] = pages(scratch_k_scale)
        cache.v_scale[:, ids] = pages(scratch_v_scale)
    return cache


def gather_contiguous(cache: PagedKVCache, page_table_row, layer_idx: int):
    """Test/debug helper: one sequence's contiguous K/V view
    [H, n_pages * page, D] for a layer (int8 dequantized to bf16)."""
    row = torch.as_tensor(np.asarray(page_table_row), dtype=torch.int32,
                          device=cache.k.device)[None]
    k, v = gather_pages(cache.k, cache.v, layer_idx, row, cache.k_scale,
                        cache.v_scale)
    return k[0], v[0]
