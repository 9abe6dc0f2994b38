"""Tensor/data-parallel forward (counterpart of the JAX package's
``parallel/tp.py``).

JAX wraps the model forward in ``shard_map`` over the ("data", "model")
mesh. Here every rank runs the same host program on the same global
inputs: ``TPForward`` slices this rank's batch rows (data axis), runs the
family's forward on its shards of the parameters and the cache with the
model axis as ``tp_axis``, and gathers the logits over the data axis, so
it is a drop-in replacement for ``models.llama.forward`` where JAX's
``make_tp_forward`` is one. The kernels see per-shard shapes; the model
code derives head counts from its local projection widths.

Collectives per layer: 2 all-reduces (o_proj, down_proj partials before
the residual adds) and, per forward, 1 all-gather of the lm_head's
column shards, plus 1 all-gather of the logits over a data axis of more
than one rank: the Megatron inference pattern.

The forward owns the cache's shape: each rank holds its batch rows and KV
heads (``init_cache``, ``init_paged_cache``). Its collectives are host
calls (gloo), so it cannot be captured in a CUDA graph (``capturable``):
the engine and the server run it eagerly on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.parallel.distributed import Mesh
from tinychatengine_tpu_torch.runtime import paged as pg


def _advance_like(cache, true_len, s: int, paged: bool) -> None:
    """The host-length advance a forward makes (``llama.last_rows``), for
    a rank that follows without computing."""
    if paged or isinstance(true_len, torch.Tensor):
        return
    if true_len is None or np.ndim(true_len) == 0:
        kvc.advance(cache, s if true_len is None else int(true_len))
    else:
        kvc.advance(cache, int(np.max(true_len)))


class TPForward:
    """``forward`` tensor-parallel over the mesh's "model" axis and
    data-parallel over "data" (``make_tp_forward``). followers: a mesh
    holding this one's ranks and others that run the same host program
    without computing (the ranks of a larger sequence-parallel prefill
    mesh, ``runtime.serving``'s SP admission): they hold caches of no KV
    heads and receive the logits by a broadcast from the mesh's first
    rank. device: where its caches are made when the caller names none
    (``None``: the card, raising without one)."""

    # gloo collectives are host calls: no CUDA graph can hold them
    capturable = False

    def __init__(self, mesh: Mesh, forward=llama.forward,
                 followers: Mesh | None = None, device=None):
        if not mesh.member and (followers is None or not followers.member):
            raise ValueError("this rank is neither in the mesh nor among "
                             "its followers")
        self.mesh, self.forward = mesh, forward
        self.followers = followers
        self.device = resolve_device(device)

    # -- the cache's shape --------------------------------------------------
    def _rows(self, batch: int) -> int:
        if not self.mesh.member:
            return batch
        n = self.mesh.shape["data"]
        if batch % n:
            raise ValueError(f"batch {batch} does not split over {n} data "
                             f"ranks")
        return batch // n

    def head_range(self, num_kv_heads: int) -> tuple[int, int]:
        """The global KV heads [lo, hi) this rank holds (none for a
        follower)."""
        if not self.mesh.member:
            return 0, 0
        n = self.mesh.shape["model"]
        if num_kv_heads % n:
            raise ValueError(f"{num_kv_heads} KV heads do not split over {n} "
                             f"model ranks")
        w = num_kv_heads // n
        i = self.mesh.coords["model"]
        return i * w, (i + 1) * w

    def _heads(self, num_kv_heads: int) -> int:
        lo, hi = self.head_range(num_kv_heads)
        return hi - lo

    def init_cache(self, num_layers: int, batch: int, max_len: int,
                   num_kv_heads: int, head_dim: int, **kw) -> kvc.KVCache:
        """``kvc.init_cache`` of this rank's rows and KV heads."""
        kw.setdefault("device", self.device)
        return kvc.init_cache(num_layers, self._rows(batch), max_len,
                              self._heads(num_kv_heads), head_dim, **kw)

    def init_paged_cache(self, num_layers: int, n_pages: int,
                         num_kv_heads: int, page_size: int, head_dim: int,
                         **kw) -> pg.PagedKVCache:
        """``pg.init_paged_cache`` of this rank's KV heads (every page)."""
        kw.setdefault("device", self.device)
        return pg.init_paged_cache(num_layers, n_pages,
                                   self._heads(num_kv_heads), page_size,
                                   head_dim, **kw)

    # -- the forward ------------------------------------------------------
    def __call__(self, params, cfg, input_ids, cache, start,
                 input_embeds=None, full_logits: bool = False,
                 true_len=None, page_table=None, ctx_cap=None):
        b, s = input_ids.shape
        if not self.mesh.member:
            return self._follow(cfg, b, s, cache, full_logits, true_len,
                                page_table is not None)
        data = self.mesh["data"]
        bl = b // data.size
        lo = data.index * bl

        def rows(x):  # this rank's rows of a per-row input
            if x is None or isinstance(x, (int, np.integer)):
                return x
            if isinstance(x, torch.Tensor):
                return x[lo:lo + bl] if x.dim() and x.shape[0] == b else x
            a = np.asarray(x)
            return a[lo:lo + bl] if a.ndim and a.shape[0] == b else x

        kw = {}
        if page_table is not None:  # the paged decode (llama, gptbigcode)
            kw["page_table"] = rows(page_table)
        if input_embeds is not None:
            kw["input_embeds"] = rows(input_embeds)
        logits, cache = self.forward(
            params, cfg, input_ids[lo:lo + bl], cache, rows(start),
            full_logits=full_logits, true_len=rows(true_len),
            ctx_cap=ctx_cap, tp_axis=self.mesh["model"], **kw)
        logits = data.all_gather(logits, dim=0)
        if self.followers is not None:
            logits = self.followers.broadcast(logits, self.mesh.ranks[0])
        return logits, cache

    def _follow(self, cfg, b, s, cache, full_logits, true_len, paged):
        shape = (b, s, cfg.vocab_size) if full_logits else (b, cfg.vocab_size)
        logits = torch.empty(shape, dtype=torch.float32,
                             device=cache.k.device)
        logits = self.followers.broadcast(logits, self.mesh.ranks[0])
        _advance_like(cache, true_len, s, paged)
        return logits, cache


def make_tp_forward(mesh: Mesh, forward=llama.forward,
                    followers: Mesh | None = None,
                    device=None) -> TPForward:
    """A drop-in replacement for ``models.llama.forward`` (or ``forward``,
    e.g. ``opt.forward``) that runs
    tensor-parallel over mesh axis "model" and data-parallel over "data".
    Its params and cache are this rank's shards (``shard_params`` with
    the family's specs, ``shard_cache``, ``shard_paged_cache``, or the
    forward's own ``init_cache``, on the card unless ``device`` says
    otherwise); it returns the global logits on every rank."""
    return TPForward(mesh, forward, followers, device)
