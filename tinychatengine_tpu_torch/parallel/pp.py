"""Pipeline parallelism: the stacked layer axis split over a "pipe" mesh
axis (counterpart of the JAX package's ``parallel/pp.py``).

Every layer leaf is stacked [L, ...]; a stage holds L/n consecutive
layers and the same slice of the KV cache, and the only traffic between
stages is one [Bm, S, E] activation per hop.

Schedule: GPipe microbatching over M + n - 1 ticks. Each tick every stage
runs its local layer stack (the family's forward with ``input_embeds`` in
and ``return_hidden`` out, so the kernels, windows and the fused decode
come along) on the microbatch it holds, then the activations move one hop
(``ppermute``). A bubble tick (a stage holding no microbatch) computes
nothing and commits nothing: JAX computes it on garbage and masks the KV
commit and the logits collection, since one SPMD program cannot branch;
each rank's host program here can. The last stage collects the logits of
every microbatch as it leaves, and a sum over the pipe axis gives them to
every rank. Pipeline efficiency is M / (M + n - 1); pick M >= n.

Composes with Megatron TP on a ("pipe", "model") mesh (llama): each stage's
layers split their columns / rows over "model" with the specs of
``parallel/tp.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.ops import ref
from tinychatengine_tpu_torch.ops.linear import apply_linear
from tinychatengine_tpu_torch.parallel.distributed import Mesh
from tinychatengine_tpu_torch.parallel.sharding import (P, llama_param_specs,
                                                        shard_kv, spec_tree,
                                                        tree_shard)


def make_pp_mesh(n_pipe: int, n_model: int = 1,
                 ranks: Optional[Sequence[int]] = None) -> Mesh:
    """("pipe", "model") mesh over the first n_pipe * n_model world ranks
    (or ``ranks``): layer stages over pipe, Megatron TP within a stage."""
    ranks = list(range(n_pipe * n_model)) if ranks is None else list(ranks)
    return Mesh(("pipe", "model"), (n_pipe, n_model), ranks)


def _replicated(leaf):
    return P(*((None,) * leaf.dim()))


def llama_pp_param_specs(params: llama.LlamaParams, tp: bool = False) -> dict:
    """Layer leaves split on axis 0 over "pipe", composed with the
    Megatron column / row specs on the trailing dims when ``tp``; the
    embedding, final norm and rope replicated; the lm_head follows the TP
    column split (only the last stage applies it)."""
    tp_specs = llama_param_specs(params)

    def stage(leaf, tp_spec):
        return P("pipe", *(tp_spec[1:] if tp else (None,) * (leaf.dim() - 1)))

    return {"embed": _replicated(params.embed),
            "layers": spec_tree(params.layers, stage, tp_specs["layers"]),
            "final_norm": _replicated(params.final_norm),
            "lm_head": (tp_specs["lm_head"] if tp
                        else spec_tree(params.lm_head, _replicated)),
            "rope_cos": _replicated(params.rope_cos),
            "rope_sin": _replicated(params.rope_sin)}


def generic_pp_param_specs(params) -> dict:
    """Family-agnostic pipe specs: the ``layers`` subtree (every family
    stacks its layer leaves on axis 0) over "pipe", the rest replicated.
    In-stage TP stays llama-only (``llama_pp_param_specs``)."""
    def pipe(leaf):
        return P("pipe", *((None,) * (leaf.dim() - 1)))

    return {f.name: spec_tree(getattr(params, f.name),
                              pipe if f.name == "layers" else _replicated)
            for f in dataclasses.fields(params)}


def _pp_family(params):
    """The stage-local hooks of a family: (embedding on stage 0, head on
    the last stage, activation dtype, whether in-stage TP specs exist)."""
    from tinychatengine_tpu_torch.models import gptbigcode as G
    from tinychatengine_tpu_torch.models import opt as O

    if isinstance(params, llama.LlamaParams):
        def embed(p, ids, positions):
            return p.embed[ids].to(torch.bfloat16)

        def head(p, h, cfg):  # h [B, 1, E] -> logits [B, 1, Vpad] f32
            hn = ref.rms_norm_ref(h, p.final_norm, cfg.rms_norm_eps)
            return apply_linear(p.lm_head, hn).float()

        return embed, head, torch.bfloat16, True
    if isinstance(params, G.GPTBigCodeParams):
        def embed(p, ids, positions):
            pos = positions.clamp(max=p.wpe.shape[0] - 1)
            return (p.wte[ids] + p.wpe[pos]).to(torch.bfloat16)

        def head(p, h, cfg):
            hn = ref.layer_norm_ref(h, p.lnf_w, p.lnf_b)
            return apply_linear(p.lm_head, hn).float()

        return embed, head, torch.bfloat16, False
    if isinstance(params, O.OPTParams):
        def embed(p, ids, positions):
            pos = (positions + O.POS_OFFSET).clamp(
                max=p.embed_positions.shape[0] - 1)
            return p.embed_tokens[ids].float() + p.embed_positions[pos].float()

        def head(p, h, cfg):
            hn = ref.layer_norm_ref(h, p.final_ln_w, p.final_ln_b)
            return apply_linear(p.lm_head, hn.to(torch.bfloat16)).float()

        return embed, head, torch.float32, False
    raise TypeError(f"no PP adapter for {type(params).__name__}")


def _pp_param_specs(params, tp: bool = False) -> dict:
    if isinstance(params, llama.LlamaParams):
        return llama_pp_param_specs(params, tp=tp)
    if tp:
        raise ValueError("in-stage TP under PP is llama-only (generic specs)")
    return generic_pp_param_specs(params)


def _pp_cache_spec(tp: bool) -> tuple:
    return P("pipe", None, "model" if tp else None, None, None)


def shard_pp(params, cache, mesh: Mesh):
    """(this rank's stage of ``params``, its stage of ``cache``); Nones
    outside the mesh."""
    if not mesh.member:
        return None, None
    tp = mesh.shape.get("model", 1) > 1
    return (tree_shard(params, _pp_param_specs(params, tp=tp), mesh),
            shard_kv(cache, _pp_cache_spec(tp), mesh))


def _rows_cache(cache: kvc.KVCache, lo: int, hi: int) -> kvc.KVCache:
    """A contiguous copy of rows [lo, hi) of ``cache`` (a microbatch's)."""
    def rows(t):
        return None if t is None else t[:, lo:hi].clone()

    return kvc.KVCache(rows(cache.k), rows(cache.v), cache.length,
                       rows(cache.k_scale), rows(cache.v_scale))


def _commit(cache: kvc.KVCache, mb: kvc.KVCache, lo: int, hi: int) -> None:
    for dst, src in ((cache.k, mb.k), (cache.v, mb.v),
                     (cache.k_scale, mb.k_scale), (cache.v_scale, mb.v_scale)):
        if dst is not None:
            dst[:, lo:hi].copy_(src)


class PPForward:
    """``make_pp_forward``'s forward. Its collectives are host calls, so
    it is not ``capturable``; it shapes its caches (``init_cache``: this
    stage's layers and, under TP, its KV heads, on ``device`` when the
    caller names none)."""

    capturable = False

    def __init__(self, mesh: Mesh, n_micro: int, forward=llama.forward,
                 device=None):
        self.mesh, self.n_micro, self.forward = mesh, n_micro, forward
        self.device = resolve_device(device)
        self.tp = mesh.shape.get("model", 1) > 1

    def init_cache(self, num_layers: int, batch: int, max_len: int,
                   num_kv_heads: int, head_dim: int, **kw) -> kvc.KVCache:
        n_pipe, n_model = self.mesh.shape["pipe"], self.mesh.shape["model"]
        kw.setdefault("device", self.device)
        return kvc.init_cache(num_layers // n_pipe, batch, max_len,
                              num_kv_heads // n_model, head_dim, **kw)

    def __call__(self, params, cfg, input_ids, cache, start,
                 input_embeds=None, full_logits: bool = False,
                 true_len=None, page_table=None, ctx_cap=None):
        if full_logits:
            raise ValueError("PP forward returns last-position logits only")
        if page_table is not None:
            raise ValueError("paged KV is not supported under PP")
        pipe = self.mesh["pipe"]
        n = pipe.size
        b, s = input_ids.shape
        m = math.gcd(self.n_micro, b)
        bm = b // m
        if cfg.num_layers % n:
            raise ValueError(f"{n} stages do not split {cfg.num_layers} "
                             f"layers")
        embed_f, head_f, act_dtype, tp_ok = _pp_family(params)
        if self.tp and not tp_ok:
            raise ValueError("in-stage TP under PP is llama-only; use a pure "
                             "pipe mesh")
        tp_kw = {"tp_axis": self.mesh["model"]} if self.tp else {}
        cfg_local = dataclasses.replace(cfg, num_layers=cfg.num_layers // n)
        dev = cache.k.device
        ragged = isinstance(start, torch.Tensor)
        if ragged:
            start = start.to(device=dev, dtype=torch.int32)
        tl = None if true_len is None else int(true_len)
        last_ix = s - 1 if tl is None else min(max(tl - 1, 0), s - 1)
        length0 = cache.length
        ids = input_ids.to(dev)
        stage = pipe.index
        embeds = None
        if stage == 0:
            if input_embeds is not None:
                embeds = input_embeds.to(dev, act_dtype)
            else:
                st = start.long()[:, None] if ragged else start
                positions = (st + torch.arange(s, device=dev)).expand(b, s)
                embeds = embed_f(params, ids, positions)
        acc = torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                          device=dev)
        x_carry = None
        for t in range(m + n - 1):
            mb = t - stage  # the microbatch this stage holds
            if 0 <= mb < m:
                lo, hi = mb * bm, (mb + 1) * bm
                x = embeds[lo:hi] if stage == 0 else x_carry
                c_mb = cache if m == 1 else _rows_cache(cache, lo, hi)
                hidden, _ = self.forward(
                    params, cfg_local, ids[lo:hi], c_mb,
                    start[lo:hi] if ragged else start, input_embeds=x,
                    return_hidden=True, ctx_cap=ctx_cap, **tp_kw)
                if m > 1:
                    _commit(cache, c_mb, lo, hi)
                if stage == n - 1:  # the microbatch leaves: its logits
                    lg = head_f(params, hidden[:, last_ix:last_ix + 1], cfg)
                    if self.tp:  # column-parallel lm_head: whole vocabulary
                        lg = self.mesh["model"].all_gather(lg, dim=-1)
                    acc[lo:hi] = lg[:, 0, :cfg.vocab_size]
            else:  # a bubble: nothing computed, nothing committed
                hidden = torch.zeros((bm, s, cfg.embed_dim), dtype=act_dtype,
                                     device=dev)
            x_carry = pipe.ppermute(hidden)
        logits = pipe.psum(acc)  # nonzero on the last stage only
        cache.length = length0 + (s if tl is None else tl)
        return logits, cache


def make_pp_forward(mesh: Mesh, n_micro: int, forward=llama.forward,
                    device=None) -> PPForward:
    """``pp_forward(params, cfg, input_ids, cache, start, ...) ->
    (last-position logits [B, V], cache)``: the stacked layers run
    pipeline-parallel over mesh axis "pipe" with n_micro microbatches cut
    from the batch (gcd(n_micro, B) when they do not divide it: a batch-1
    admission prefill is one microbatch). params and cache: this rank's
    stage (``shard_pp``). ``start`` may be a per-row [B] tensor (ragged
    decode), ``input_embeds`` replaces the embedding lookup, ``true_len``
    picks the last real position of a right-padded prompt, ``ctx_cap``
    reaches the decode kernel. No paged KV, no ``full_logits``; in-stage
    TP for llama only. device: as ``make_tp_forward``'s."""
    return PPForward(mesh, n_micro, forward, device)
