"""GPTBigCode (StarCoder) decoder: fp and int4 (W4A16, W4A8), single device
(counterpart of the JAX package's ``models/gptbigcode.py``, with per-row
positions, the paged decode of the serving path, ``input_embeds`` (the
pipeline-parallel stage contract), ``return_hidden`` and the Megatron
``tp_axis`` hook).

Architecture: multi-query attention (one KV head shared by every query
head; ``flash_decode`` / ``flash_prefill`` / ``flash_decode_paged`` take
G = Hq), a fused ``c_attn`` projection [q | k | v] with bias, tanh-GELU
MLP, LayerNorm with bias, learned absolute positions (no offset), tied
head in fp, an int4 head for the int4 schemes.

Fused decode (``ops.int4_matmul.FUSED_DECODE``, off by default): a
one-token step of a W4A16 model whose linears pass JAX's gate
(``fused_group_size``) folds the LayerNorms into the c_attn, fc_in and
lm_head matmuls, the linear biases into their epilogues and the residual
adds into c_proj and fc_out (``int4_matmul_fused``); GELU stays outside.

Parameters are dataclasses with every layer leaf stacked [L, ...] (field
names are the checkpoint's tree paths).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.models.llama import fusable, last_rows, records
from tinychatengine_tpu_torch.models.opt import stack_layers
from tinychatengine_tpu_torch.ops import attention as att
from tinychatengine_tpu_torch.ops import int4_matmul as int4m
from tinychatengine_tpu_torch.ops import ref
from tinychatengine_tpu_torch.ops.attention import (flash_decode,
                                                   flash_decode_paged,
                                                   flash_prefill)
from tinychatengine_tpu_torch.ops.linear import (DenseLinear, Int4A8Linear,
                                                 Int4Linear, apply_linear,
                                                 random_int4_linear,
                                                 random_int4_linear_fast,
                                                 row_parallel)
from tinychatengine_tpu_torch.quant.packing import numpy_to_torch
from tinychatengine_tpu_torch.runtime import paged as pg


@dataclasses.dataclass
class GPTBigCodeLayerParams:
    """All decoder layers, every leaf stacked [L, ...]."""

    ln1_w: torch.Tensor   # [L, E]
    ln1_b: torch.Tensor
    c_attn: object        # E -> E + 2 * head_dim (q | one k head | one v head)
    c_proj: object        # E -> E
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc_in: object         # E -> F
    fc_out: object        # F -> E


@dataclasses.dataclass
class GPTBigCodeParams:
    wte: torch.Tensor     # [V, E]
    wpe: torch.Tensor     # [max_pos, E]
    layers: GPTBigCodeLayerParams
    lnf_w: torch.Tensor   # [E]
    lnf_b: torch.Tensor
    lm_head: object       # E -> V


def fused_group_size(lyr: GPTBigCodeLayerParams, s: int) -> int:
    """The group size of the fused decode when this step takes it, else 0:
    the switch is on, S == 1 and every layer linear is fusable (biases
    allowed) at c_attn's group size (JAX's gate)."""
    if not (int4m.FUSED_DECODE and s == 1
            and fusable(lyr.c_attn, bias_ok=True)):
        return 0
    gs = lyr.c_attn.group_size
    ok = all(fusable(p, gs, bias_ok=True)
             for p in (lyr.c_attn, lyr.c_proj, lyr.fc_in, lyr.fc_out))
    return gs if ok else 0


def forward(params: GPTBigCodeParams, cfg: ModelConfig,
            input_ids: torch.Tensor, cache, start, full_logits: bool = False,
            true_len=None, input_embeds: Optional[torch.Tensor] = None,
            page_table: Optional[torch.Tensor] = None,
            ctx_cap: Optional[int] = None, return_hidden: bool = False,
            tp_axis=None):
    """Same contract as ``models.llama.forward``: one forward pass (prefill
    S > 1 or decode S = 1) writing the new K/V into ``cache`` in place.
    ``start``: a host int or an int32 [B] tensor (per-row positions);
    ``true_len``: an int, a ragged [B] sequence or a device tensor
    (``llama.last_rows``); ``input_embeds`` [B, S, E]: the
    position-included embeddings, cast to bf16, in place of
    ``wte[ids] + wpe[positions]`` (input_ids then give only the shape);
    ``page_table``: the paged decode (S = 1, per-row
    ``start``); ``ctx_cap``: ``flash_decode``'s static bound on every
    row's context; ``return_hidden``: the states before the final
    LayerNorm [B, S, E] instead of logits; ``tp_axis``: the model axis of
    a tensor-parallel mesh (``parallel.distributed.Axis``): c_proj and
    fc_out sum their partials over it before their bias and the residual
    (``row_parallel``), the fused decode's c_proj / fc_out stay unfused,
    and the lm_head's column shards are gathered. Returns (logits [B, V]
    f32 of the last position, or [B, S, V] with full_logits, and the
    cache)."""
    b, s = input_ids.shape
    dev = params.wte.device
    ragged = isinstance(start, torch.Tensor)
    if page_table is not None and (s != 1 or not ragged):
        raise ValueError("a paged forward is a decode step: S = 1 and a "
                         "per-row start tensor")
    if ragged:
        start = start.to(device=dev, dtype=torch.int32)
        st_col = start.long()[:, None]
        kv_len = start + s
        if page_table is None:  # bucket padding may reach past the cache
            kv_len = kv_len.clamp(max=cache.max_len)
    else:
        if s == 1 and start >= cache.max_len:
            raise ValueError(f"KV cache full: position {start} >= max_len "
                             f"{cache.max_len}")
        st_col = torch.full((1, 1), start, dtype=torch.long, device=dev)
        kv_len = min(start + s, cache.max_len)
    positions = (st_col + torch.arange(s, device=dev)).expand(b, s)
    # the JAX gather clamps out-of-range rows; only bucket padding past the
    # table reaches them
    pos_rows = positions.clamp(max=params.wpe.shape[0] - 1)
    if input_embeds is not None:
        x = input_embeds.to(dev, torch.bfloat16)
    else:
        x = (params.wte[input_ids.to(dev)] + params.wpe[pos_rows]
             ).to(torch.bfloat16)

    lyr = params.layers
    d = cfg.head_dim
    gs = fused_group_size(lyr, s)
    fused = int4m.int4_matmul_fused
    for li in range(cfg.num_layers):
        if gs:  # LayerNorm in c_attn's prologue, its bias in the epilogue
            qkv = fused(x, lyr.c_attn.packed, lyr.c_attn.scales, gs,
                        layer_idx=li, norm_w=lyr.ln1_w, norm_b=lyr.ln1_b,
                        bias=lyr.c_attn.bias)
        else:
            h = ref.layer_norm_ref(x, lyr.ln1_w[li], lyr.ln1_b[li])
            qkv = apply_linear(lyr.c_attn, h, layer_idx=li)
        nq = qkv.shape[-1] - 2 * d
        hq = nq // d
        q = qkv[..., :nq].reshape(b, s, hq, d)
        k = qkv[..., nq:nq + d].reshape(b, s, 1, d)  # MQA: one KV head
        v = qkv[..., nq + d:].reshape(b, s, 1, d)
        if page_table is not None:
            pg.paged_update_layer(cache, k, v, li, start, page_table)
            attn = flash_decode_paged(q[:, 0], cache.k, cache.v, li, kv_len,
                                      page_table, cache.k_scale,
                                      cache.v_scale).reshape(b, 1, hq * d)
        else:
            kvc.update_layer(cache, k, v, li, start)
            if records(q):
                attn = att.flash_prefill_plain(q, cache.k, cache.v, li, start,
                                               kv_len, cache.k_scale,
                                               cache.v_scale)
            elif s == 1:
                attn = flash_decode(q[:, 0], cache.k, cache.v, li, kv_len,
                                    cache.k_scale, cache.v_scale,
                                    ctx_cap=ctx_cap).reshape(b, 1, hq * d)
            else:
                attn = flash_prefill(q, cache.k, cache.v, li, start, kv_len,
                                     cache.k_scale, cache.v_scale)
        if gs and tp_axis is None:  # c_proj's bias and the residual add in
            # its epilogue
            x = fused(attn.to(x.dtype), lyr.c_proj.packed, lyr.c_proj.scales,
                      gs, layer_idx=li, bias=lyr.c_proj.bias, residual=x)
        else:  # the bias once, after the partials' sum (Megatron's rule)
            x = x + row_parallel(lyr.c_proj, attn.to(x.dtype), tp_axis,
                                 layer_idx=li).to(x.dtype)
        if gs:
            f = fused(x, lyr.fc_in.packed, lyr.fc_in.scales, gs, layer_idx=li,
                      norm_w=lyr.ln2_w, norm_b=lyr.ln2_b, bias=lyr.fc_in.bias)
        else:
            h2 = ref.layer_norm_ref(x, lyr.ln2_w[li], lyr.ln2_b[li])
            f = apply_linear(lyr.fc_in, h2, layer_idx=li)
        f = ref.gelu_ref(f.float()).to(x.dtype)
        if gs and tp_axis is None:
            x = fused(f, lyr.fc_out.packed, lyr.fc_out.scales, gs,
                      layer_idx=li, bias=lyr.fc_out.bias, residual=x)
        else:
            x = x + row_parallel(lyr.fc_out, f, tp_axis,
                                 layer_idx=li).to(x.dtype)

    x = last_rows(x, cache, true_len, s, full_logits or return_hidden,
                  page_table is None)
    if return_hidden:
        return x, cache
    head = params.lm_head
    if gs and fusable(head, bias_ok=True):  # lnf in the head's prologue
        logits = fused(x, head.packed, head.scales, head.group_size,
                       norm_w=params.lnf_w, norm_b=params.lnf_b,
                       bias=head.bias)
    else:
        x = ref.layer_norm_ref(x, params.lnf_w, params.lnf_b)
        logits = apply_linear(head, x)
    logits = logits.float()
    if tp_axis is not None:  # column-parallel lm_head: the whole vocabulary
        logits = tp_axis.all_gather(logits, dim=-1)
    return (logits if full_logits else logits[:, 0]), cache


def params_from_numpy(flat: dict, cfg: ModelConfig, qcfg: QuantConfig,
                      device=None) -> GPTBigCodeParams:
    """The port's parameters from the flat tree-path-keyed dict of the
    checkpoint format (``layers/c_attn/packed``, ``wpe``, ``lnf_b``, ...):
    the function that carries a JAX tree's weights across. A linear with a
    ``weight`` leaf is dense; one with ``packed``/``scales`` is int4, as
    W4A8 when ``qcfg.scheme == "w4a8"``."""
    dev = resolve_device(device)

    def leaf(key):
        return numpy_to_torch(flat[key]).to(dev)

    def lin(prefix):
        bias = leaf(f"{prefix}/bias") if f"{prefix}/bias" in flat else None
        if f"{prefix}/weight" in flat:
            return DenseLinear(weight=leaf(f"{prefix}/weight"), bias=bias)
        cls = Int4A8Linear if qcfg.scheme == "w4a8" else Int4Linear
        return cls(packed=leaf(f"{prefix}/packed"),
                   scales=leaf(f"{prefix}/scales"), bias=bias)

    names = ("ln1_w", "ln1_b", "ln2_w", "ln2_b")
    return GPTBigCodeParams(
        wte=leaf("wte"), wpe=leaf("wpe"),
        layers=GPTBigCodeLayerParams(
            **{n: leaf(f"layers/{n}") for n in names},
            **{n: lin(f"layers/{n}")
               for n in ("c_attn", "c_proj", "fc_in", "fc_out")}),
        lnf_w=leaf("lnf_w"), lnf_b=leaf("lnf_b"), lm_head=lin("lm_head"))


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       qcfg: Optional[QuantConfig] = None, fast: bool = False,
                       device=None) -> GPTBigCodeParams:
    """Random weights in the JAX package's structure (tests, benchmarks).

    fp (``qcfg`` None or scheme fp): every leaf drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order, so the tree
    equals its ``init_random_params`` bit for bit. w4a16 / w4a8: int4
    linears with f32 biases and an int4 head without one; JAX draws the
    int4 weights with ``jax.random``, which the port cannot repeat, so they
    are drawn with numpy and quantized here (parity runs through
    ``params_from_numpy``). fast=True (int4 only) makes the packed bytes,
    scales (``qcfg.scale_dtype``), biases and embeddings directly on the
    device from a seeded ``torch.Generator`` (full-size models)."""
    dev = resolve_device(device)
    scheme = getattr(qcfg, "scheme", "fp")
    int4 = scheme in ("w4a16", "w4a8")
    if fast and not int4:
        raise ValueError("fast=True makes int4 weights: pass a w4a16 or "
                         "w4a8 qcfg")
    cls = Int4A8Linear if scheme == "w4a8" else Int4Linear
    nl, e, f, v, d = (cfg.num_layers, cfg.embed_dim, cfg.hidden_dim,
                      cfg.vocab_size, cfg.head_dim)
    if fast:
        return _fast_int4_params(cfg, qcfg, cls, seed, dev)
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).to(dev)

    def dense(k, n):
        if int4:
            p = random_int4_linear(rng, k, n, qcfg.group_size, device=dev)
            bias = torch.from_numpy(np.asarray(
                rng.standard_normal(n) * 0.01, np.float32)).to(dev)
            return cls(packed=p.packed, scales=p.scales, bias=bias)
        return DenseLinear(weight=bf16(rng.standard_normal((k, n)) * 0.02),
                           bias=bf16(rng.standard_normal(n) * 0.01))

    def ones_zeros():
        return (torch.ones((e,), dtype=torch.bfloat16, device=dev),
                torch.zeros((e,), dtype=torch.bfloat16, device=dev))

    layers = []
    for _ in range(nl):
        ln1_w, ln1_b = ones_zeros()
        c_attn, c_proj = dense(e, e + 2 * d), dense(e, e)
        ln2_w, ln2_b = ones_zeros()
        fc_in, fc_out = dense(e, f), dense(f, e)
        layers.append(GPTBigCodeLayerParams(
            ln1_w=ln1_w, ln1_b=ln1_b, c_attn=c_attn, c_proj=c_proj,
            ln2_w=ln2_w, ln2_b=ln2_b, fc_in=fc_in, fc_out=fc_out))
    wte = bf16(rng.standard_normal((v, e)) * 0.02)
    if int4:
        p = random_int4_linear(rng, e, v, qcfg.group_size, device=dev)
        head = cls(packed=p.packed, scales=p.scales)
    else:
        head = DenseLinear(weight=wte.T)
    lnf_w, lnf_b = ones_zeros()
    return GPTBigCodeParams(
        wte=wte, wpe=bf16(rng.standard_normal((cfg.max_sqlen, e)) * 0.02),
        layers=stack_layers(layers), lnf_w=lnf_w, lnf_b=lnf_b, lm_head=head)


def _fast_int4_params(cfg: ModelConfig, qcfg: QuantConfig, cls, seed: int,
                      dev) -> GPTBigCodeParams:
    """Layer-stacked random int4 parameters made on ``dev``: codes centered
    on the zero point (``random_int4_linear_fast(centered=True)``), scales
    as there, biases N(0, 0.01) f32, LayerNorms ones / zeros, embeddings
    N(0, 0.02) bf16. Uniform bytes (codes averaging 7.5) would make the
    model ill-conditioned: fc_out, fed GELU's mostly positive outputs,
    would add about -0.5 * d * sum(x), some -37 at starcoder_15.5b's width,
    to every column, and the bf16 residual stream would spend its precision
    on that offset."""
    nl, e, f, v, d = (cfg.num_layers, cfg.embed_dim, cfg.hidden_dim,
                      cfg.vocab_size, cfg.head_dim)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def lin(k, n, bias=True):
        p = random_int4_linear_fast(gen, k, n, qcfg.group_size,
                                    scale_dtype=qcfg.scale_dtype, device=dev,
                                    n_layers=nl if bias else None,
                                    centered=True)
        b = (torch.randn((nl, n), device=dev, generator=gen) * 0.01
             if bias else None)
        return cls(packed=p.packed, scales=p.scales, bias=b)

    def ln(value):
        return torch.full((nl, e), value, dtype=torch.bfloat16, device=dev)

    def emb(rows):
        return (torch.randn((rows, e), device=dev, generator=gen) * 0.02
                ).to(torch.bfloat16)

    return GPTBigCodeParams(
        wte=emb(v), wpe=emb(cfg.max_sqlen),
        layers=GPTBigCodeLayerParams(
            ln1_w=ln(1.0), ln1_b=ln(0.0), c_attn=lin(e, e + 2 * d),
            c_proj=lin(e, e), ln2_w=ln(1.0), ln2_b=ln(0.0), fc_in=lin(e, f),
            fc_out=lin(f, e)),
        lnf_w=torch.ones((e,), dtype=torch.bfloat16, device=dev),
        lnf_b=torch.zeros((e,), dtype=torch.bfloat16, device=dev),
        lm_head=lin(e, v, bias=False))
