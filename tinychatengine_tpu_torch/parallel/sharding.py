"""Meshes of ranks and the Megatron sharding rules (counterpart of the JAX
package's ``parallel/sharding.py``).

A ``("data", "model")`` mesh of ranks where

- the ``model`` axis tensor-parallelizes weights and KV heads
  (column-parallel q/k/v/gate/up, row-parallel o/down; the model code
  sums the row-parallel partials through the axis, ``tp_axis``),
- the ``data`` axis batch-parallelizes independent sequences.

A spec names, for each dim of a leaf, the mesh axis it is split over
(``None``: whole on every rank): a tuple per tensor, in a tree of dicts
that mirrors the parameter dataclasses (JAX's ``PartitionSpec`` pytrees).
``shard_params`` and ``shard_cache`` slice this rank's shard out of the
global leaves every rank holds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from tinychatengine_tpu_torch.models.llama import LlamaParams
from tinychatengine_tpu_torch.ops.linear import (DenseLinear, Int4Linear,
                                                 W8A8Linear)
from tinychatengine_tpu_torch.parallel.distributed import Mesh


def P(*names) -> tuple:
    """A spec: one mesh-axis name (or None) per dim of a leaf."""
    return tuple(names)


def make_mesh(n_data: int = 1, n_model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """("data", "model") mesh over the first n_data * n_model world ranks
    (or ``ranks``). Every member must make it, in the same order as its
    other meshes; ranks outside it may skip it."""
    ranks = list(range(n_data * n_model)) if ranks is None else list(ranks)
    return Mesh(("data", "model"), (n_data, n_model), ranks)


def _lead(leaf, *trailing) -> tuple:
    return P(*((None,) * (leaf.dim() - len(trailing))), *trailing)


def _linear_spec(p, shard_axis: str, logical_k: Optional[int] = None):
    """Spec tree of one (possibly layer-stacked) linear. shard_axis "col":
    N over "model" (q/k/v/gate/up); "row": K over "model" (o/down).
    logical_k: the model's true input width of a row-parallel linear; a
    K padded at pack time is refused, since an even split of the packed
    rows would misalign every later shard's weights against its x slice
    (such models need a conversion per shard)."""
    col = shard_axis == "col"
    k_ax, n_ax = (None, "model") if col else ("model", None)

    def bias(b):
        return None if b is None else _lead(b, "model" if col else None)

    if isinstance(p, Int4Linear):  # Int4A8Linear too
        if not col and logical_k is not None \
                and 2 * p.packed.shape[-2] != logical_k:
            raise ValueError(
                f"row-parallel TP over pack-time-padded K "
                f"({2 * p.packed.shape[-2]} stored vs logical {logical_k}): "
                f"convert per-shard instead")
        return {"packed": _lead(p.packed, k_ax, n_ax),
                "scales": _lead(p.scales, k_ax, n_ax), "bias": bias(p.bias)}
    if isinstance(p, DenseLinear):
        return {"weight": _lead(p.weight, k_ax, n_ax), "bias": bias(p.bias)}
    if isinstance(p, W8A8Linear):
        return {"weight": _lead(p.weight, k_ax, n_ax),
                "alpha": _lead(p.alpha), "bias": bias(p.bias)}
    raise TypeError(type(p))


def _replicated(leaf):
    return None if leaf is None else _lead(leaf)


def llama_param_specs(params: LlamaParams) -> dict:
    """Megatron TP specs of the llama parameters."""
    ly = params.layers
    embed_dim = params.embed.shape[-1]
    gu = ly.wgate_up
    hidden = (gu.weight if isinstance(gu, DenseLinear) else gu.packed
              ).shape[-1] // 2
    return {
        "embed": _replicated(params.embed),
        "layers": {
            "input_norm": _replicated(ly.input_norm),
            "wqkv": _linear_spec(ly.wqkv, "col"),
            "wo": _linear_spec(ly.wo, "row", logical_k=embed_dim),
            "post_norm": _replicated(ly.post_norm),
            "wgate_up": _linear_spec(ly.wgate_up, "col"),
            "down": _linear_spec(ly.down, "row", logical_k=hidden)},
        "final_norm": _replicated(params.final_norm),
        "lm_head": _linear_spec(params.lm_head, "col"),
        "rope_cos": _replicated(params.rope_cos),
        "rope_sin": _replicated(params.rope_sin)}


def opt_param_specs(params) -> dict:
    """Megatron TP specs of the OPT parameters (MHA: heads split evenly)."""
    ly = params.layers
    return {
        "embed_tokens": _replicated(params.embed_tokens),
        "embed_positions": _replicated(params.embed_positions),
        "layers": {
            "attn_ln_w": _replicated(ly.attn_ln_w),
            "attn_ln_b": _replicated(ly.attn_ln_b),
            "q_proj": _linear_spec(ly.q_proj, "col"),
            "k_proj": _linear_spec(ly.k_proj, "col"),
            "v_proj": _linear_spec(ly.v_proj, "col"),
            "out_proj": _linear_spec(ly.out_proj, "row"),
            "final_ln_w": _replicated(ly.final_ln_w),
            "final_ln_b": _replicated(ly.final_ln_b),
            "fc1": _linear_spec(ly.fc1, "col"),
            "fc2": _linear_spec(ly.fc2, "row"),
            "qk_alpha": _replicated(ly.qk_alpha),
            "pv_alpha": _replicated(ly.pv_alpha)},
        "final_ln_w": _replicated(params.final_ln_w),
        "final_ln_b": _replicated(params.final_ln_b),
        "lm_head": _linear_spec(params.lm_head, "col")}


def cache_spec() -> tuple:
    """KV cache [L, B, H_kv, S, D]: batch over data, KV heads over model."""
    return P(None, "data", "model", None, None)


def shard_slice(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view)."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n, i = mesh.shape[name], mesh.coords[name]
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{n} ways over {name!r}")
        w = size // n
        t = t.narrow(dim, i * w, w)
    return t


def spec_tree(tree, fn, specs=None):
    """The spec tree of ``tree`` (dataclasses of tensors): ``fn(leaf)`` at
    each tensor, or ``fn(leaf, spec)`` alongside a spec tree ``specs``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree) if specs is None else fn(tree, specs)
    return {f.name: spec_tree(getattr(tree, f.name), fn,
                              None if specs is None else specs[f.name])
            for f in dataclasses.fields(tree)}


def tree_shard(tree, specs, mesh: Mesh):
    """``tree`` (dataclasses of tensors) with every leaf replaced by its
    shard under ``specs`` (dicts mirroring the dataclasses), each a copy
    of its own so the global leaves can be freed."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return shard_slice(tree, specs, mesh).clone()
    return type(tree)(**{f.name: tree_shard(getattr(tree, f.name),
                                            specs[f.name], mesh)
                         for f in dataclasses.fields(tree)})


def shard_params(params, mesh: Mesh, specs_fn=None):
    """This rank's shard of the global ``params`` (llama specs by default);
    None on a rank outside the mesh."""
    specs = (specs_fn or llama_param_specs)(params)
    return tree_shard(params, specs, mesh) if mesh.member else None


def shard_kv(cache, spec: tuple, mesh: Mesh):
    """This rank's block of a ``KVCache`` or ``PagedKVCache`` under the
    spec of its K / V buffers (the scales drop the last dim); None
    outside the mesh."""
    if not mesh.member:
        return None

    def block(t, sp):
        return None if t is None else shard_slice(t, sp, mesh).clone()

    bufs = dict(k=block(cache.k, spec), v=block(cache.v, spec),
                k_scale=block(cache.k_scale, spec[:-1]),
                v_scale=block(cache.v_scale, spec[:-1]))
    if hasattr(cache, "length"):
        bufs["length"] = cache.length
    return type(cache)(**bufs)


def shard_cache(cache, mesh: Mesh):
    """This rank's rows and KV heads of a global ``KVCache``."""
    return shard_kv(cache, cache_spec(), mesh)


def paged_spec() -> tuple:
    """Page pool [L, pages, H_kv, page, D]: KV heads over model."""
    return P(None, None, "model", None, None)


def shard_paged_cache(cache, mesh: Mesh):
    """This rank's KV heads of a global ``PagedKVCache``."""
    return shard_kv(cache, paged_spec(), mesh)
