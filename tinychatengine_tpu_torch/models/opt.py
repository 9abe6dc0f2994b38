"""OPT decoder: fp, int4 (W4A16, W4A8) and SmoothQuant W8A8 (counterpart
of the JAX package's ``models/opt.py``; Megatron tensor parallelism through
``tp_axis``, no paged KV). ``input_embeds (f32, positions included) replaces the
embedding lookup, the pipeline-parallel stage contract.

The W8A8 path keeps the Int8OPT dataflow exactly:

    LayerNormQ (fp32 LN -> round -> int8)
    -> W8A8 q/k/v (int32 product, * alpha + bias, requant to int8)
    -> raw int8 KV cache (the static scales live in the BMM alphas)
    -> logits = (q_s8 . k_s8) * qk_alpha -> fp32 softmax -> x127 int8 probs
    -> (p_s8 . v_s8) * pv_alpha -> int8 -> W8A8 out_proj (f32 out) + residual
    FFN: LayerNormQ -> W8A8 fc1 with ReLU (int8 out) -> W8A8 fc2 (f32 out).

A decode step (S = 1) runs its attention through ``int8_decode`` (the
kernel on the card); a prompt (S > 1) through the dense int8 dataflow in
plain torch, as in the JAX package, which has no kernel there either. The
fp and int4 paths run ``flash_decode`` / ``flash_prefill`` on the card for
head_dim 64 and 128, and the dense f32 attention otherwise, on the CPU and
while autograd records (``llama.records``: training).

Architecture: learned positions with offset 2, pre-LN LayerNorm with bias,
ReLU FFN, tied head. Parameters are dataclasses with every layer leaf
stacked [L, ...] (field names are the checkpoint's tree paths).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.models.llama import (last_rows, lmhead_padded,
                                                  records)
from tinychatengine_tpu_torch.ops import ref
from tinychatengine_tpu_torch.ops.attention import (NEG_INF,
                                                   exact_f32_products,
                                                   flash_decode, flash_prefill,
                                                   int8_decode, int8_probs)
from tinychatengine_tpu_torch.ops.linear import (DenseLinear, Int4A8Linear,
                                                 Int4Linear, W8A8Linear,
                                                 apply_linear,
                                                 random_int4_linear,
                                                 row_parallel)
from tinychatengine_tpu_torch.quant.packing import numpy_to_torch

POS_OFFSET = 2  # OPT's learned positions start at row 2


@dataclasses.dataclass
class OPTLayerParams:
    """All decoder layers, every leaf stacked [L, ...]."""

    attn_ln_w: torch.Tensor   # LayerNorm(Q) weight [L, E]
    attn_ln_b: torch.Tensor
    q_proj: object
    k_proj: object
    v_proj: object
    out_proj: object
    final_ln_w: torch.Tensor  # pre-FFN LayerNorm(Q)
    final_ln_b: torch.Tensor
    fc1: object
    fc2: object
    qk_alpha: Optional[torch.Tensor] = None  # [L] f32 (W8A8 only)
    pv_alpha: Optional[torch.Tensor] = None


@dataclasses.dataclass
class OPTParams:
    embed_tokens: torch.Tensor     # [V, E]
    embed_positions: torch.Tensor  # [max_pos + 2, E]
    layers: OPTLayerParams
    final_ln_w: torch.Tensor
    final_ln_b: torch.Tensor
    lm_head: object                # tied to embed_tokens (int4: padded N)


def _masked(logits, positions, kv_valid):
    """Scores [B, H, S, S_max] with key ``col`` kept for query position
    ``pos`` iff col <= pos and col < kv_valid (int or [B]), else NEG_INF."""
    col = torch.arange(logits.shape[-1], device=logits.device)
    allowed = (col[None, None, :] <= positions[:, :, None]) \
        & (col[None, None, :] < kv_valid.reshape(-1, 1, 1))
    return torch.where(allowed[:, None], logits, NEG_INF)


def _s8_attention(q, ck, cv, qk_alpha, pv_alpha, positions, kv_valid):
    """The dense Int8OPT attention of a prompt chunk: q [B, S, H, D] int8
    against one cache layer [B, H, S_max, D] int8 (mask as ``_masked``).
    Returns the int8 output [B, S, H * D]."""
    b, s, h, d = q.shape
    exact_f32_products(q)
    logits = _masked(torch.einsum("bshd,bhtd->bhst", q.float(), ck.float())
                     * qk_alpha, positions, kv_valid)
    attn = torch.einsum("bhst,bhtd->bshd", int8_probs(logits), cv.float()) \
        * pv_alpha
    return torch.clamp(torch.round(attn), -128, 127).to(torch.int8) \
        .reshape(b, s, h * d)


def forward(params: OPTParams, cfg: ModelConfig, input_ids: torch.Tensor,
            cache, start, full_logits: bool = False, true_len=None,
            tp_axis=None, input_embeds=None, ctx_cap: Optional[int] = None,
            return_hidden: bool = False, page_table=None):
    """Same contract as ``models.llama.forward``: one forward pass writing
    the new K/V into ``cache`` in place. ``start``: a host int or an int32
    [B] tensor (per-row positions); ``true_len``: an int, a ragged [B]
    sequence or a device tensor (``llama.last_rows``). The container types
    pick the path. ``ctx_cap`` reaches ``flash_decode`` (the fp and int4
    decode; ``int8_decode`` takes none, as in JAX). ``return_hidden``
    returns the pre-final-LN states [B, S, E] instead of logits.
    ``input_embeds`` [B, S, E]: the position-included embeddings, cast to
    f32, in place of the token and position lookup (input_ids then give
    only the shape). ``tp_axis``: the model axis of a tensor-parallel mesh
    (``parallel.distributed.Axis``): params and cache hold this rank's
    heads and columns, out_proj and fc2 sum their partials over it before
    their bias (``row_parallel``), and the lm_head's column shards are
    gathered. OPT has no paged path: a ``page_table`` raises."""
    if page_table is not None:
        raise NotImplementedError("paged KV is not ported for OPT")
    b, s = input_ids.shape
    dev = params.embed_tokens.device
    ragged = isinstance(start, torch.Tensor)
    if ragged:
        start = start.to(device=dev, dtype=torch.int32)
        st_col = start.long()[:, None]
        kv_len = start + s
    else:
        if s == 1 and start >= cache.max_len:
            raise ValueError(f"KV cache full: position {start} >= max_len "
                             f"{cache.max_len}")
        st_col = torch.full((1, 1), start, dtype=torch.long, device=dev)
        kv_len = start + s
    positions = (st_col + torch.arange(s, device=dev)).expand(b, s)
    # the JAX gather clamps out-of-range rows; only bucket padding past the
    # table reaches them
    pos_rows = (positions + POS_OFFSET).clamp(
        max=params.embed_positions.shape[0] - 1)
    if input_embeds is not None:
        x = input_embeds.to(dev, torch.float32)
    else:
        x = (params.embed_tokens[input_ids.to(dev)].float()
             + params.embed_positions[pos_rows].float())

    lyr = params.layers
    d = cfg.head_dim
    int8_path = isinstance(lyr.q_proj, W8A8Linear)
    use_flash = not int8_path and x.is_cuda and d in (64, 128)
    if use_flash:  # bucket padding may reach past the cache
        kv_len = kv_len.clamp(max=cache.max_len) if ragged \
            else min(kv_len, cache.max_len)
    kv_valid = kv_len if ragged else torch.full((), kv_len, device=dev)
    for li in range(cfg.num_layers):
        if int8_path:
            h = ref.layer_norm_q_ref(x, lyr.attn_ln_w[li], lyr.attn_ln_b[li])
        else:
            h = ref.layer_norm_ref(x, lyr.attn_ln_w[li], lyr.attn_ln_b[li])
        q = apply_linear(lyr.q_proj, h, out_int8=int8_path, layer_idx=li)
        k = apply_linear(lyr.k_proj, h, out_int8=int8_path, layer_idx=li)
        v = apply_linear(lyr.v_proj, h, out_int8=int8_path, layer_idx=li)
        hq = q.shape[-1] // d
        q, k, v = (t.reshape(b, s, hq, d) for t in (q, k, v))
        kvc.update_layer(cache, k, v, li, start)

        if int8_path and s == 1:
            attn = int8_decode(q[:, 0], cache.k, cache.v, li, kv_len,
                               lyr.qk_alpha[li], lyr.pv_alpha[li])
            attn = torch.clamp(torch.round(attn), -128, 127) \
                .to(torch.int8).reshape(b, 1, hq * d)
        elif int8_path:
            ck, cv = kvc.read_layer(cache, li)  # raw int8 [B, H, S_max, D]
            attn = _s8_attention(q, ck, cv, lyr.qk_alpha[li],
                                 lyr.pv_alpha[li], positions, kv_valid)
        elif use_flash and not records(q):
            qb = q.to(torch.bfloat16)
            if s == 1:
                attn = flash_decode(qb[:, 0], cache.k, cache.v, li, kv_len,
                                    cache.k_scale, cache.v_scale,
                                    ctx_cap=ctx_cap)
            else:
                attn = flash_prefill(qb, cache.k, cache.v, li, start, kv_len,
                                     cache.k_scale, cache.v_scale)
            attn = attn.float().reshape(b, s, hq * d)
        else:
            ck, cv = kvc.read_layer(cache, li)  # [B, H, S_max, D]
            logits = _masked(torch.einsum("bshd,bhtd->bhst", q.float(),
                                          ck.float())
                             * ref.xla_recip(d ** 0.5),
                             positions, kv_valid)
            attn = torch.einsum("bhst,bhtd->bshd", torch.softmax(logits, -1),
                                cv.float()).reshape(b, s, hq * d)
        x = x + row_parallel(lyr.out_proj, attn, tp_axis,
                             layer_idx=li).float()

        if int8_path:
            h2 = ref.layer_norm_q_ref(x, lyr.final_ln_w[li],
                                      lyr.final_ln_b[li])
            f = apply_linear(lyr.fc1, h2, out_int8=True, relu=True,
                             layer_idx=li)
        else:
            h2 = ref.layer_norm_ref(x, lyr.final_ln_w[li], lyr.final_ln_b[li])
            f = torch.clamp_min(
                apply_linear(lyr.fc1, h2, layer_idx=li).float(), 0.0)
        x = x + row_parallel(lyr.fc2, f, tp_axis, layer_idx=li).float()

    x = last_rows(x, cache, true_len, s, full_logits or return_hidden, True)
    if return_hidden:
        return x, cache
    x = ref.layer_norm_ref(x, params.final_ln_w, params.final_ln_b)
    logits = apply_linear(params.lm_head, x.to(torch.bfloat16)).float()
    if tp_axis is not None:  # column-parallel lm_head: the whole vocabulary
        logits = tp_axis.all_gather(logits, dim=-1)
    logits = logits[..., :cfg.vocab_size]
    return (logits if full_logits else logits[:, 0]), cache


def params_from_numpy(flat: dict, cfg: ModelConfig, qcfg: QuantConfig,
                      device=None) -> OPTParams:
    """The port's parameters from the flat tree-path-keyed dict of the
    checkpoint format (``layers/q_proj/weight``, ``layers/qk_alpha``, ...).
    A linear whose ``weight`` is int8 and that has an ``alpha`` leaf is
    W8A8; another ``weight`` is dense; ``packed``/``scales`` is int4, as
    W4A8 when ``qcfg.scheme == "w4a8"``."""
    dev = resolve_device(device)

    def leaf(key):
        return None if key not in flat else numpy_to_torch(flat[key]).to(dev)

    def lin(prefix):
        bias = leaf(f"{prefix}/bias")
        w = leaf(f"{prefix}/weight")
        if w is not None and w.dtype == torch.int8 \
                and f"{prefix}/alpha" in flat:
            return W8A8Linear(weight=w, alpha=leaf(f"{prefix}/alpha"),
                              bias=bias)
        if w is not None:
            return DenseLinear(weight=w, bias=bias)
        cls = Int4A8Linear if qcfg.scheme == "w4a8" else Int4Linear
        return cls(packed=leaf(f"{prefix}/packed"),
                   scales=leaf(f"{prefix}/scales"), bias=bias)

    names = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
    return OPTParams(
        embed_tokens=leaf("embed_tokens"),
        embed_positions=leaf("embed_positions"),
        layers=OPTLayerParams(
            attn_ln_w=leaf("layers/attn_ln_w"),
            attn_ln_b=leaf("layers/attn_ln_b"),
            final_ln_w=leaf("layers/final_ln_w"),
            final_ln_b=leaf("layers/final_ln_b"),
            qk_alpha=leaf("layers/qk_alpha"), pv_alpha=leaf("layers/pv_alpha"),
            **{n: lin(f"layers/{n}") for n in names}),
        final_ln_w=leaf("final_ln_w"), final_ln_b=leaf("final_ln_b"),
        lm_head=lin("lm_head"))


def stack_layers(per_layer: list):
    """Per-layer containers (nested dataclasses of tensors) -> one container
    with every leaf stacked [L, ...]."""
    first = per_layer[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(per_layer)
    return type(first)(**{
        f.name: stack_layers([getattr(p, f.name) for p in per_layer])
        for f in dataclasses.fields(first)})


def init_random_params(cfg: ModelConfig, quantized: bool = False,
                       seed: int = 0, qcfg: Optional[QuantConfig] = None,
                       fast: bool = False, device=None) -> OPTParams:
    """Random weights in the JAX package's structure (tests, benchmarks).

    quantized=True gives W8A8 containers; ``qcfg`` with scheme w4a16 / w4a8
    gives int4 containers for every projection and the head. The fp and
    W8A8 leaves are drawn from ``np.random.default_rng(seed)`` in the JAX
    package's order, so they equal its ``init_random_params`` bit for bit.
    fast=True (W8A8 only) makes the weights on ``device`` from a seeded
    ``torch.Generator`` with the layout-only values of the JAX package's
    ``scripts/bench_opt_w8a8.py`` (full-size models)."""
    dev = resolve_device(device)
    if fast:
        if not quantized:
            raise ValueError("fast=True makes W8A8 weights: pass "
                             "quantized=True")
        return _fast_w8a8_params(cfg, seed, dev)
    rng = np.random.default_rng(seed)
    e, f, v = cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size
    scheme = getattr(qcfg, "scheme", None)
    int4 = scheme in ("w4a16", "w4a8")

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def dense(k, n):
        return DenseLinear(weight=f32(rng.standard_normal((k, n)) * 0.02),
                           bias=f32(rng.standard_normal(n) * 0.01))

    def w8a8(k, n, alpha=0.002):
        return W8A8Linear(
            weight=torch.from_numpy(rng.integers(-127, 128, (k, n))
                                    .astype(np.int8)).to(dev),
            alpha=torch.tensor(alpha, dtype=torch.float32, device=dev),
            bias=f32(rng.integers(-10, 10, (n,))))

    def int4_lin(k, n, bias=True):
        p = random_int4_linear(rng, k, n, qcfg.group_size, device=dev)
        cls = Int4A8Linear if scheme == "w4a8" else Int4Linear
        return cls(packed=p.packed, scales=p.scales,
                   bias=f32(rng.standard_normal(n) * 0.01) if bias else None)

    lin = int4_lin if int4 else (w8a8 if quantized else dense)
    out = int4_lin if int4 else (
        (lambda k, n: w8a8(k, n, 0.004)) if quantized else dense)
    ln_w = 20.0 if quantized else 1.0
    layers = []
    for _ in range(cfg.num_layers):
        q_proj, k_proj, v_proj = lin(e, e), lin(e, e), lin(e, e)
        out_proj, fc1, fc2 = out(e, e), lin(e, f), out(f, e)
        layers.append(OPTLayerParams(
            attn_ln_w=torch.full((e,), ln_w, device=dev),
            attn_ln_b=torch.zeros((e,), device=dev),
            q_proj=q_proj, k_proj=k_proj, v_proj=v_proj, out_proj=out_proj,
            final_ln_w=torch.full((e,), ln_w, device=dev),
            final_ln_b=torch.zeros((e,), device=dev), fc1=fc1, fc2=fc2,
            qk_alpha=torch.tensor(1e-4, device=dev) if quantized else None,
            pv_alpha=torch.tensor(1e-4, device=dev) if quantized else None))
    embed = f32(rng.standard_normal((v, e)) * 0.02)
    if int4:  # the head is int4 too, bias-less and N-padded
        lm_head = int4_lin(e, lmhead_padded(v), bias=False)
    else:
        lm_head = DenseLinear(weight=embed.T.to(torch.bfloat16))
    return OPTParams(
        embed_tokens=embed,
        embed_positions=f32(rng.standard_normal(
            (cfg.max_sqlen + POS_OFFSET, e)) * 0.02),
        layers=stack_layers(layers),
        final_ln_w=torch.ones((e,), device=dev),
        final_ln_b=torch.zeros((e,), device=dev),
        lm_head=lm_head)


def _fast_w8a8_params(cfg: ModelConfig, seed: int, dev) -> OPTParams:
    """Layer-stacked random W8A8 parameters made on ``dev``: LN weights 20,
    linear alphas 0.002 (q/k/v, fc1) and 0.004 (out_proj, fc2), biases
    uniform in [-8, 8), BMM alphas 1e-4."""
    nl, e, f, v = cfg.num_layers, cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w8(k, n, alpha):  # made N-major, W8A8Linear's layout
        return W8A8Linear(
            weight=torch.randint(-127, 128, (nl, n, k), dtype=torch.int8,
                                 device=dev, generator=gen).transpose(1, 2),
            alpha=torch.full((nl,), alpha, device=dev),
            bias=torch.rand((nl, n), device=dev, generator=gen) * 16 - 8)

    embed = torch.randn((v, e), device=dev, generator=gen) * 0.02
    return OPTParams(
        embed_tokens=embed,
        embed_positions=torch.randn((cfg.max_sqlen + POS_OFFSET, e),
                                    device=dev, generator=gen) * 0.02,
        layers=OPTLayerParams(
            attn_ln_w=torch.full((nl, e), 20.0, device=dev),
            attn_ln_b=torch.zeros((nl, e), device=dev),
            q_proj=w8(e, e, 0.002), k_proj=w8(e, e, 0.002),
            v_proj=w8(e, e, 0.002), out_proj=w8(e, e, 0.004),
            final_ln_w=torch.full((nl, e), 20.0, device=dev),
            final_ln_b=torch.zeros((nl, e), device=dev),
            fc1=w8(e, f, 0.002), fc2=w8(f, e, 0.004),
            qk_alpha=torch.full((nl,), 1e-4, device=dev),
            pv_alpha=torch.full((nl,), 1e-4, device=dev)),
        final_ln_w=torch.ones((e,), device=dev),
        final_ln_b=torch.zeros((e,), device=dev),
        lm_head=DenseLinear(weight=embed.T.to(torch.bfloat16)))
