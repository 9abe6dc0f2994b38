"""LLaMA-family decoder (counterpart of the JAX package's
``models/llama.py``, with per-row positions, the paged decode of the
serving path, the fused decode branch, ``input_embeds``, the VLM's
spliced prompt, and the multi-device hooks: ``tp_axis`` (Megatron tensor
parallelism, ``parallel/tp.py``) and ``sp_axis`` (the sequence-parallel
ring prefill, ``parallel/sp.py``)).

Fused decode (``ops.int4_matmul.FUSED_DECODE``, off by default): a
one-token step of a W4A16 model whose linears pass JAX's shape gate
(``fused_group_size``) folds the RMSNorms into the qkv, gate_up and
lm_head matmuls, RoPE into the qkv matmul and the residual adds into wo and
down (``int4_matmul_fused``), in the contiguous and the paged decode alike.

Parameters are dataclasses of tensors with every layer leaf stacked [L, ...]
as in the JAX package; the forward walks the layers in a Python loop and
hands ``layer_idx`` to the kernels, which read the layer straight from the
stacked buffers. q/k/v and gate/up are fused column-wise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.ops import attention as att
from tinychatengine_tpu_torch.ops import int4_matmul as int4m
from tinychatengine_tpu_torch.ops import ref
from tinychatengine_tpu_torch.ops.attention import (flash_decode,
                                                   flash_decode_paged,
                                                   flash_prefill)
from tinychatengine_tpu_torch.ops.linear import (
    DenseLinear,
    Int4A8Linear,
    Int4Linear,
    apply_linear,
    fuse_linears,
    random_int4_linear,
    random_int4_linear_fast,
    row_parallel,
)
from tinychatengine_tpu_torch.quant.packing import SUPERBLOCK, numpy_to_torch
from tinychatengine_tpu_torch.runtime import paged as pg

LMHEAD_PAD = 2048  # lm_head N padded to a multiple of this; the forward
# slices the logits back to vocab_size


def lmhead_padded(v: int) -> int:
    return ((v + LMHEAD_PAD - 1) // LMHEAD_PAD) * LMHEAD_PAD


def fusable(p, group_size: Optional[int] = None,
            bias_ok: bool = False) -> bool:
    """JAX's ``_fusable``: a W4A16 ``Int4Linear`` (W4A8 is another kind
    there) whose K is a whole number of superblocks with a multiple of 8
    scale rows at ``group_size`` (default its own) and whose N is a
    multiple of 128; without a bias unless ``bias_ok`` (GPTBigCode's
    gate)."""
    if not isinstance(p, Int4Linear) or isinstance(p, Int4A8Linear) \
            or (p.bias is not None and not bias_ok):
        return False
    group_size = group_size or p.group_size
    k = 2 * p.packed.shape[-2]
    return (k % SUPERBLOCK == 0 and (k // group_size) % 8 == 0
            and p.packed.shape[-1] % 128 == 0)


def fused_group_size(lyr: "LlamaLayerParams", cfg: ModelConfig,
                     s: int) -> int:
    """The group size of the fused decode when this step takes it, else 0.
    A static shape gate, as in JAX: the switch is on, S == 1, head_dim in
    (64, 128, 256) (the RoPE epilogue's tiling there), and every layer
    linear is fusable at the qkv group size with its K unpadded (the norm
    runs over the whole row)."""
    if not (int4m.FUSED_DECODE and s == 1 and cfg.head_dim in (64, 128, 256)
            and fusable(lyr.wqkv)):
        return 0
    gs = lyr.wqkv.group_size
    e, f = cfg.embed_dim, cfg.hidden_dim
    lins = ((lyr.wqkv, e), (lyr.wo, e), (lyr.wgate_up, e), (lyr.down, f))
    ok = all(fusable(p, gs) and 2 * p.packed.shape[-2] == k_in
             for p, k_in in lins)
    return gs if ok else 0


@dataclasses.dataclass
class LlamaLayerParams:
    """All decoder layers, every leaf stacked [L, ...]."""

    input_norm: torch.Tensor  # [L, E]
    wqkv: object              # E -> (Hq + 2*Hkv)*D
    wo: object                # Hq*D -> E
    post_norm: torch.Tensor   # [L, E]
    wgate_up: object          # E -> 2F (SiLU gate | up)
    down: object              # F -> E


@dataclasses.dataclass
class LlamaParams:
    embed: torch.Tensor       # [V, E]
    layers: LlamaLayerParams
    final_norm: torch.Tensor  # [E]
    lm_head: object           # E -> V (N possibly padded, see lmhead_padded)
    rope_cos: torch.Tensor    # [max_pos, D] f32
    rope_sin: torch.Tensor


def forward(params: LlamaParams, cfg: ModelConfig, input_ids: torch.Tensor,
            cache, start, full_logits: bool = False, true_len=None,
            page_table: Optional[torch.Tensor] = None,
            ctx_cap: Optional[int] = None, return_hidden: bool = False,
            input_embeds: Optional[torch.Tensor] = None, tp_axis=None,
            sp_axis=None):
    """One forward pass (prefill S > 1 or decode S = 1), writing the new
    K/V into ``cache`` in place.

    input_ids [B, S] int. start: number of cached tokens, a host int (every
    row) or an int32 [B] tensor on the device (per-row positions, RoPE,
    cache writes and attention lengths: the serving path).
    true_len: for a prompt right-padded to a bucket, its unpadded length,
    an int or an int [B] sequence (ragged rows of a batched admission):
    the cache advances by true_len (by its largest row) and the
    last-position logits are taken at each row's true_len - 1. A 0-d or
    [B] int tensor on the device (a captured prefill) is never read on the
    host: the rows are gathered on the device and the cache's host length
    is the caller's to advance (``last_rows``).
    page_table: int32 [B, max_pages] on the device. The cache is then a
    ``runtime.paged.PagedKVCache``, S must be 1 and ``start`` carries the
    per-row lengths; the pool has no length to advance.
    ctx_cap: JAX's static bound on every row's context in a decode step
    with per-row ``start`` (``flash_decode``'s grid); the caller keeps
    start + 1 <= ctx_cap. return_hidden: the states before the final norm
    [B, S, E] instead of logits. input_embeds: [B, S, E], cast to bf16, in
    place of the embedding gather (a VLM prompt: text rows of the table
    with the image's embeddings spliced in); input_ids then give only the
    shape.
    tp_axis: the model axis of a tensor-parallel mesh
    (``parallel.distributed.Axis``): params and cache hold this rank's
    column / row shards and KV heads, the wo and down partials are summed
    over the axis before the residual add and the lm_head's column shards
    gathered before the vocabulary slice; head counts come from the local
    projection widths. sp_axis: the seq axis of a fresh sequence-parallel
    prefill: input_ids and the cache hold this rank's S/n slice (scalar
    ``start`` 0), attention runs as a ring over the axis
    (``ops.attention.ring_attention``), ``true_len`` is the global prompt
    length, and the last-token logits are summed from the rank that owns
    position true_len - 1, so every rank returns them.
    Returns (logits [B, V] f32 of the last position, or [B, S, V] with
    full_logits, and the cache)."""
    b, s = input_ids.shape
    dev = params.embed.device
    ragged = isinstance(start, torch.Tensor)
    if page_table is not None and (s != 1 or not ragged):
        raise ValueError("a paged forward is a decode step: S = 1 and a "
                         "per-row start tensor")
    if ragged:
        start = start.to(device=dev, dtype=torch.int32)
        st_col = start.long()[:, None]
    else:
        if s == 1 and start >= cache.max_len:
            raise ValueError(f"KV cache full: position {start} >= max_len "
                             f"{cache.max_len}")
        st_col = torch.full((1, 1), start, dtype=torch.long, device=dev)
    if input_embeds is not None:
        x = input_embeds.to(dev, torch.bfloat16)
    else:
        x = params.embed[input_ids.to(dev)].to(torch.bfloat16)
    positions = (st_col + torch.arange(s, device=dev)).expand(b, s)
    if sp_axis is not None:  # this rank's slice of the global sequence
        if ragged or start != 0:
            raise ValueError("a sequence-parallel forward is a fresh "
                             "prefill: scalar start 0")
        positions = positions + sp_axis.index * s
    # the JAX gather clamps out-of-range indices; so does this one (only
    # bucket padding past the table can reach it)
    rope_pos = positions.clamp(max=params.rope_cos.shape[0] - 1)
    cos = params.rope_cos[rope_pos].float()  # [B, S, D]
    sin = params.rope_sin[rope_pos].float()
    if ragged:  # per-row attention lengths (int32), built once
        kv_len = start + s
        if page_table is None:  # bucket padding may reach past the cache
            kv_len = kv_len.clamp(max=cache.max_len)
    else:
        # bucket padding may reach past the cache; real rows never do, so
        # the attention length is capped there
        kv_len = min(start + s, cache.max_len)

    lyr = params.layers
    d = cfg.head_dim
    ratio = cfg.num_heads // cfg.num_kv_heads
    win = cfg.sliding_window
    eps = cfg.rms_norm_eps
    gs = fused_group_size(lyr, cfg, s)
    fused = int4m.int4_matmul_fused
    for li in range(cfg.num_layers):
        if gs:  # RMSNorm in the qkv matmul's prologue, RoPE in its epilogue
            hkv = lyr.wqkv.packed.shape[-1] // (d * (ratio + 2))
            qkv = fused(x, lyr.wqkv.packed, lyr.wqkv.scales, gs, layer_idx=li,
                        norm_w=lyr.input_norm, norm_eps=eps,
                        rope_cos=cos[:, 0], rope_sin=sin[:, 0],
                        rope_qk_cols=(ratio + 1) * hkv * d, head_dim=d)
        else:
            h = ref.rms_norm_ref(x, lyr.input_norm[li], eps)
            qkv = apply_linear(lyr.wqkv, h, layer_idx=li)
        hkv = qkv.shape[-1] // (d * (ratio + 2))
        hq = ratio * hkv
        q = qkv[..., :hq * d].reshape(b, s, hq, d)
        k = qkv[..., hq * d:(hq + hkv) * d].reshape(b, s, hkv, d)
        v = qkv[..., (hq + hkv) * d:].reshape(b, s, hkv, d)
        if not gs:
            q, k = ref.apply_rotary(q, k, cos, sin)
        if page_table is not None:
            pg.paged_update_layer(cache, k, v, li, start, page_table)
            attn = flash_decode_paged(q[:, 0], cache.k, cache.v, li, kv_len,
                                      page_table, cache.k_scale,
                                      cache.v_scale, window=win)
            attn = attn.reshape(b, 1, hq * d)
        else:
            kvc.update_layer(cache, k, v, li, start)
            if sp_axis is not None:  # the ring over the freshly projected
                # q/k/v (a fresh prefill: the cache holds nothing before)
                attn = att.ring_attention(q, k, v, positions, sp_axis,
                                          window=win)
            elif records(q):
                attn = att.flash_prefill_plain(q, cache.k, cache.v, li, start,
                                               kv_len, cache.k_scale,
                                               cache.v_scale, window=win)
            elif s == 1:
                attn = flash_decode(q[:, 0], cache.k, cache.v, li, kv_len,
                                    cache.k_scale, cache.v_scale, window=win,
                                    ctx_cap=ctx_cap).reshape(b, 1, hq * d)
            else:
                attn = flash_prefill(q, cache.k, cache.v, li, start, kv_len,
                                     cache.k_scale, cache.v_scale, window=win)
        if gs and tp_axis is None:  # residual in wo's epilogue, the
            # post-norm in gate_up's prologue
            x = fused(attn.to(x.dtype), lyr.wo.packed, lyr.wo.scales, gs,
                      layer_idx=li, residual=x)
            gu = fused(x, lyr.wgate_up.packed, lyr.wgate_up.scales, gs,
                       layer_idx=li, norm_w=lyr.post_norm, norm_eps=eps)
        else:  # under TP the partials are summed before the residual add
            x = x + row_parallel(lyr.wo, attn.to(x.dtype), tp_axis,
                                 layer_idx=li)
            if gs and page_table is None:  # as in JAX: the paged decode
                # leaves gate_up unfused under TP, the contiguous one not
                gu = fused(x, lyr.wgate_up.packed, lyr.wgate_up.scales, gs,
                           layer_idx=li, norm_w=lyr.post_norm, norm_eps=eps)
            else:
                h2 = ref.rms_norm_ref(x, lyr.post_norm[li], eps)
                gu = apply_linear(lyr.wgate_up, h2, layer_idx=li)
        f = gu.shape[-1] // 2
        act = (ref.silu_ref(gu[..., :f].float())
               * gu[..., f:].float()).to(x.dtype)
        if gs and tp_axis is None:
            x = fused(act, lyr.down.packed, lyr.down.scales, gs, layer_idx=li,
                      residual=x)
        else:
            x = x + row_parallel(lyr.down, act, tp_axis, layer_idx=li)

    owner = None
    if sp_axis is not None:
        x, owner = _sp_last_rows(x, cache, true_len, s, sp_axis,
                                 full_logits or return_hidden)
    else:
        x = last_rows(x, cache, true_len, s, full_logits or return_hidden,
                      page_table is None)
    if return_hidden:
        return x, cache
    head = params.lm_head
    if gs and fusable(head):  # the final norm in the head's prologue
        logits = fused(x, head.packed, head.scales, head.group_size,
                       norm_w=params.final_norm, norm_eps=eps)
    else:
        x = ref.rms_norm_ref(x, params.final_norm, eps)
        logits = apply_linear(head, x)
    logits = logits.float()
    if tp_axis is not None:  # column-parallel lm_head: the whole vocabulary
        logits = tp_axis.all_gather(logits, dim=-1)
    logits = logits[..., :cfg.vocab_size]
    if owner is not None:  # every rank gets the owner's last-token logits
        mine = owner == sp_axis.index
        logits = sp_axis.psum(logits if mine else torch.zeros_like(logits))
    return (logits if full_logits else logits[:, 0]), cache


def _sp_last_rows(x, cache, true_len, s: int, sp_axis, keep_all: bool):
    """``last_rows`` of a sequence-parallel prefill: the cache advances by
    the global prompt length (true_len, or s times the axis size) and,
    unless ``keep_all``, each rank keeps its candidate for the global last
    token, which rank ``owner`` holds. Returns (x, owner or None)."""
    n_new = s * sp_axis.size if true_len is None else int(true_len)
    kvc.advance(cache, n_new)
    if keep_all:
        return x, None
    owner = (n_new - 1) // s
    local = min(max(n_new - 1 - owner * s, 0), s - 1)
    return x[:, local:local + 1], owner


def records(q: torch.Tensor) -> bool:
    """Whether autograd records this forward (grad enabled and q needing
    grad: training). The attention kernels have no backward, so such a
    forward takes the differentiable plain attention on either device, as
    the JAX forward takes ``attention_xla`` off the TPU."""
    return torch.is_grad_enabled() and q.requires_grad


def last_rows(x: torch.Tensor, cache, true_len, s: int, keep_all: bool,
              advance: bool) -> torch.Tensor:
    """The end of every family's forward: advance the cache's host length
    (when ``advance``) by the chunk's real length and, unless ``keep_all``,
    keep each row's last real position of x [B, S, E] ([B, 1, E]).
    true_len: None (all S rows are real), a host int, a ragged [B] host
    sequence (the cache advances by its largest row), or an int tensor on
    x's device, 0-d or [B], which is never read on the host: its rows are
    gathered on the device and the cache is not advanced (a captured
    prefill; its caller sets the host length)."""
    b = x.shape[0]
    if isinstance(true_len, torch.Tensor):
        if keep_all:
            return x
        idx = (true_len.long().reshape(-1) - 1).expand(b)
        return torch.gather(x, 1, idx[:, None, None].expand(b, 1, x.shape[-1]))
    if true_len is None or np.ndim(true_len) == 0:
        n_new = s if true_len is None else int(true_len)
        if advance:
            kvc.advance(cache, n_new)
        # the lm_head runs on the last real position
        return x if keep_all else x[:, n_new - 1:n_new]
    lens = torch.as_tensor(np.asarray(true_len), dtype=torch.long,
                           device=x.device)
    if advance:
        kvc.advance(cache, int(lens.max()))
    if keep_all:
        return x
    idx = (lens - 1)[:, None, None].expand(b, 1, x.shape[-1])
    return torch.gather(x, 1, idx)


def params_from_numpy(flat: dict, cfg: ModelConfig, qcfg: QuantConfig,
                      device=None) -> LlamaParams:
    """The port's parameters from the flat tree-path-keyed dict of the
    checkpoint format (``layers/wqkv/packed``, ``lm_head/scales``, ...).
    A linear with a ``weight`` leaf is dense; one with ``packed``/``scales``
    is int4, as W4A8 when ``qcfg.scheme == "w4a8"``."""
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

    return LlamaParams(
        embed=leaf("embed"),
        layers=LlamaLayerParams(
            input_norm=leaf("layers/input_norm"), wqkv=lin("layers/wqkv"),
            wo=lin("layers/wo"), post_norm=leaf("layers/post_norm"),
            wgate_up=lin("layers/wgate_up"), down=lin("layers/down")),
        final_norm=leaf("final_norm"),
        lm_head=lin("lm_head"),
        rope_cos=leaf("rope_cos"), rope_sin=leaf("rope_sin"))


def init_random_params(cfg: ModelConfig, qcfg: QuantConfig, seed: int = 0,
                       max_pos: Optional[int] = None, fast: bool = False,
                       device=None, centered: bool = False,
                       tp_degree: int = 1, std: float = 0.02) -> LlamaParams:
    """Random weights in the right structure (benchmarks and tests).
    fast=True makes packed bytes and scales directly on the device from a
    seeded ``torch.Generator`` (layout-only fidelity, for full-size models),
    with codes centred on the zero point when ``centered``
    (``random_int4_linear_fast``; uniform bytes put a common offset into
    every output, and a deep model's greedy tokens then barely depend on
    its input); otherwise weights are drawn on the host with numpy and
    quantized. tp_degree: the fused qkv / gate_up columns interleaved for a
    tensor-parallel mesh of that many ranks (``fuse_linears``), drawn in
    the same order at any degree, so one seed gives the same projections
    at every degree. std: the linears' weight scale (the embedding keeps
    0.02); at 0.02 a linear over K = 4096 multiplies its input's RMS by
    about 1.4, so a deep centred model amplifies a change of rounding
    (chip_smoke.py ``PAR_STD``)."""
    dev = resolve_device(device)
    e, f, v = cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size
    hq, hkv, d, nl = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    quant = qcfg.scheme in ("w4a16", "w4a8")

    def as_kind(p):
        return Int4A8Linear(p.packed, p.scales, p.bias) \
            if qcfg.scheme == "w4a8" else p

    def lin(k, n, n_layers=None):
        if quant and fast:
            return as_kind(random_int4_linear_fast(
                gen, k, n, qcfg.group_size, std=std,
                scale_dtype=qcfg.scale_dtype, device=dev, n_layers=n_layers,
                centered=centered))
        count = 1 if n_layers is None else n_layers
        if quant:
            ps = [random_int4_linear(rng, k, n, qcfg.group_size, std=std,
                                     scale_dtype=qcfg.scale_dtype, device=dev)
                  for _ in range(count)]
            p = Int4Linear(torch.stack([p.packed for p in ps]),
                           torch.stack([p.scales for p in ps]))
        else:
            w = torch.from_numpy(rng.standard_normal((count, k, n),
                                                     dtype=np.float32) * std)
            p = DenseLinear(weight=w.to(torch.bfloat16).to(dev))
        if n_layers is None:
            p = dataclasses.replace(
                p, **{fl.name: getattr(p, fl.name)[0]
                      for fl in dataclasses.fields(p)
                      if getattr(p, fl.name) is not None})
        return as_kind(p) if quant else p

    ones = torch.ones((nl, e), dtype=torch.bfloat16, device=dev)
    layers = LlamaLayerParams(
        input_norm=ones.clone(),
        wqkv=fuse_linears([lin(e, hq * d, nl), lin(e, hkv * d, nl),
                           lin(e, hkv * d, nl)], tp_degree),
        wo=lin(hq * d, e, nl),
        post_norm=ones.clone(),
        wgate_up=fuse_linears([lin(e, f, nl), lin(e, f, nl)], tp_degree),
        down=lin(f, e, nl))
    cos, sin = ref.make_rope_cache(d, max_pos or cfg.max_sqlen,
                                   cfg.rope_theta, device=dev)
    if fast:
        embed = (torch.randn((v, e), generator=gen, device=dev) * 0.02
                 ).to(torch.bfloat16)
    else:
        embed = torch.from_numpy(rng.standard_normal((v, e)) * 0.02
                                 ).to(torch.bfloat16).to(dev)
    return LlamaParams(
        embed=embed, layers=layers,
        final_norm=torch.ones((e,), dtype=torch.bfloat16, device=dev),
        lm_head=lin(e, lmhead_padded(v)),
        rope_cos=cos, rope_sin=sin)
