"""Sequence-parallel (ring-attention) prefill over a ("seq", "model") mesh
(counterpart of the JAX package's ``parallel/sp.py``).

The prompt is split over the "seq" axis: each rank embeds and projects its
S/n slice, attention runs as a ring (``ops.attention.ring_attention``: the
KV slices travel round the axis through ``ppermute`` while an
online-softmax accumulator folds one slice per hop), and everything else
in a layer works token by token with no communication. Heads and columns
split over "model" as in ``parallel/tp.py`` (the ring names only "seq").

What comes back is ready for decode: the last real token's logits on
every rank (summed from the rank that owns position true_len - 1), and
this rank's block of the prefill cache, which ``sp_cache_into`` gathers
and splices into a decode cache.
"""

from __future__ import annotations

from typing import Optional, Sequence

from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation.kv_cache import KVCache
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.parallel.distributed import Mesh
from tinychatengine_tpu_torch.parallel.sharding import P, shard_kv


def make_sp_mesh(n_seq: int, n_model: int = 1,
                 ranks: Optional[Sequence[int]] = None) -> Mesh:
    """("seq", "model") mesh over the first n_seq * n_model world ranks (or
    ``ranks``): the ring over seq, Megatron TP over model."""
    ranks = list(range(n_seq * n_model)) if ranks is None else list(ranks)
    return Mesh(("seq", "model"), (n_seq, n_model), ranks)


def shard_sp_cache(cache: KVCache, mesh: Mesh) -> Optional[KVCache]:
    """This rank's block of a prefill-sized cache (max_len == the prompt
    bucket S): its S/n positions over "seq" and its KV heads over "model".
    None outside the mesh."""
    return shard_kv(cache, P(None, None, "model", "seq", None), mesh)


def make_sp_prefill(mesh: Mesh, forward=llama.forward, device=None):
    """``sp_prefill(params, cfg, input_ids, cache, true_len=None,
    full_logits=False) -> (logits, cache)``: a fresh-prompt prefill running
    sequence-parallel over mesh axis "seq" (and tensor-parallel over
    "model" when that axis has more than one rank). params: this rank's
    model-axis shard (``shard_params(params, mesh)``); input_ids [B, S]:
    the whole prompt, on every rank; cache: this rank's block of a
    prompt-sized cache (``shard_sp_cache``). S must split over the seq
    axis. Returns the last-token logits [B, V] (or, with full_logits, all
    [B, S, V], gathered over seq) on every rank, and the cache block.
    device: where the ids go (``None``: the card, raising without one)."""
    dev = resolve_device(device)
    n_seq = mesh.shape["seq"]
    tp = mesh.shape["model"] > 1

    def sp_prefill(params, cfg, input_ids, cache, true_len=None,
                   full_logits: bool = False):
        b, s = input_ids.shape
        if s % n_seq:
            raise ValueError(f"prompt of {s} does not split over {n_seq} "
                             f"seq ranks")
        s_loc = s // n_seq
        if cache.max_len != s_loc:
            raise ValueError(f"SP prefill cache must be prompt-sized "
                             f"({cache.max_len * n_seq} != {s})")
        seq = mesh["seq"]
        ids = input_ids[:, seq.index * s_loc:(seq.index + 1) * s_loc].to(dev)
        tl = None if true_len is None else int(true_len)
        logits, cache = forward(params, cfg, ids, cache, 0, true_len=tl,
                                full_logits=full_logits, sp_axis=seq,
                                tp_axis=mesh["model"] if tp else None)
        if full_logits:
            logits = seq.all_gather(logits, dim=1)
        return logits, cache

    return sp_prefill


def sp_cache_into(dst: KVCache, src: KVCache, mesh: Mesh,
                  heads: Optional[tuple[int, int]] = None) -> KVCache:
    """Splice a sequence-parallel prefill cache (``src``: this rank's block
    of it) into a decode cache at position 0, in place: the blocks are
    gathered over the mesh's "seq" and "model" axes (every rank of the
    mesh takes part) and ``dst`` receives the global KV heads [lo, hi) of
    ``heads`` (default: all of them, a single-device decode cache; a
    tensor-parallel decode rank passes its ``head_range``). The length
    carries over."""
    if dst.quantized != src.quantized:
        raise ValueError("sp_cache_into: int8 and bf16 caches do not mix")
    seq, model = mesh["seq"], mesh["model"]
    s = src.max_len * seq.size
    if dst.max_len < s:
        raise ValueError(f"decode cache of {dst.max_len} < prompt {s}")

    pairs = [(dst.k, src.k), (dst.v, src.v)]
    if dst.quantized:
        pairs += [(dst.k_scale, src.k_scale), (dst.v_scale, src.v_scale)]
    for d, sr in pairs:  # [L, B, H, S(, D)]: positions over seq, heads model
        g = model.all_gather(seq.all_gather(sr, dim=3), dim=2)
        lo, hi = (0, g.shape[2]) if heads is None else heads
        if hi > lo:
            d[:, :, :, :s] = g[:, :, lo:hi].to(d.dtype)
    dst.length = src.length
    return dst
