"""Plain f32 reference of the Mellum decoder (Mellum2-12B-A2.5B's
equations, Hugging Face's names): token embedding; per layer RMSNorm,
fused q | k | v projection (head-major columns, heads of ``head_dim``),
rotate-half RoPE at ``rope_theta`` (sliding layers) or YaRN's frequencies
and attention factor (full layers), causal attention with grouped KV heads
(a sliding layer's query at p sees keys p - window + 1 .. p), output
projection, residual; RMSNorm, then the sparse-expert block: router logits
in f32, softmax, the top k renormalised over the chosen, each chosen
expert's SiLU(gate) * up and down projection weighted and summed; residual;
final RMSNorm and the lm_head (its columns past the vocabulary dropped).
Weights come from ``perfbench.weights`` for the run's seed (experts keyed
(layer, expert)), one layer at a time.

Plain PyTorch in f32 with TF32 off (``common.strict_f32``), no kernel of
the port, no cache, no batching. The router routes on this reference's own
f32 logits. Departures from the published model, as the configuration's
``assumed`` records: no q/k norm (the config declares none), no MTP head,
a bf16 router. Each linear, the router and the experts included, takes
its input rows at the ``Seq``'s precisions, so a control's lowered
precision reaches every product.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.common import (attention, fake_quant, kv_quant,
                                        linear, row_bits_tensor,
                                        wanted_rows)
from perfbench.weights import Weights


def dense(w: Weights, name: str, layer=None) -> torch.Tensor:
    """A linear's f32 weight [K, N] at its true K (the stored pad rows
    dropped)."""
    return w.dense(name, layer)[:w.model.true_k(name)]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def inv_freq(m, kind: str, device) -> torch.Tensor:
    """Inverse frequencies [D / 2] (f64) of a layer's RoPE: θ^(-2i/D), or
    YaRN's blend of them and the interpolated ones (÷ factor), extrapolated
    above the correction range of beta_fast and interpolated below that of
    beta_slow, a linear ramp between (floored / ceiled, clamped to
    [0, D - 1])."""
    d, theta = m.head_dim, m.rope_theta
    base = theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                  device=device) / d)
    extra = 1.0 / base
    if kind == "default":
        return extra
    factor, orig, fast, slow, _ = m.yarn

    def corr(rot):
        return d * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(fast)), 0)
    high = min(math.ceil(corr(slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float64, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return extra / factor * (1.0 - keep) + extra * keep


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
         scale: float) -> torch.Tensor:
    """Rotate-half RoPE of x [T, H, D] at positions [T] (angles in f64),
    cos and sin times ``scale``."""
    d = x.shape[-1]
    ang = pos.double()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos = (ang.cos() * scale).float()[:, None]
    sin = (ang.sin() * scale).float()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def experts(w: Weights, li: int, h: torch.Tensor, bits: torch.Tensor
            ) -> torch.Tensor:
    """The sparse-expert block of layer ``li`` over normed rows h [T, E]."""
    m = w.model
    logits = linear(h, m.router(w, li).float(), bits, m.group)
    p = torch.softmax(logits, dim=-1)
    top, ids = torch.topk(p, m.top_k, dim=-1)
    if m.norm_topk_prob:
        top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    f = m.expert_dim
    for e in torch.unique(ids).tolist():
        rows, slot = (ids == e).nonzero(as_tuple=True)
        gu = linear(h[rows], dense(w, "experts_gate_up", (li, e)),
                    bits[rows], m.group)
        act = torch.nn.functional.silu(gu[:, :f]) * gu[:, f:]
        del gu
        out.index_add_(0, rows, top[rows, slot][:, None]
                       * linear(act, dense(w, "experts_down", (li, e)),
                                bits[rows], m.group))
    return out


@torch.inference_mode()
def logits(w: Weights, seqs: list, device) -> list:
    """Logits [len(want), V] f32 of each ``Seq`` at its wanted positions."""
    m = w.model
    d, hq, hkv = m.head_dim, m.heads, m.kv_heads
    bits = row_bits_tensor(seqs, device)
    kvb, resb = seqs[0].kv_bits, seqs[0].res_bits
    ids = torch.as_tensor(np.concatenate([s.ids for s in seqs]),
                          device=device)
    x = w.table("embed", m.vocab)[ids].float()
    del ids
    lens = [len(s.ids) for s in seqs]
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    freqs = {k: inv_freq(m, k, device) for k in set(m.layer_rope)}
    scales = {"default": 1.0, "yarn": m.yarn[4]}
    in_norm, post_norm = w.norm("input_norm"), w.norm("post_norm")
    for li in range(m.layers):
        kind, window = m.layer_rope[li], m.layer_windows[li]
        h = rms_norm(x, in_norm[li], m.eps)
        qkv = linear(h, dense(w, "wqkv", li), bits, m.group)
        q = rope(qkv[:, :hq * d].reshape(-1, hq, d), pos, freqs[kind],
                 scales[kind])
        k = rope(qkv[:, hq * d:(hq + hkv) * d].reshape(-1, hkv, d), pos,
                 freqs[kind], scales[kind])
        v = qkv[:, (hq + hkv) * d:].reshape(-1, hkv, d)
        del qkv, h
        k, v = kv_quant(k, kvb), kv_quant(v, kvb)
        att = torch.cat([attention(qs, ks, vs, window) for qs, ks, vs in
                         zip(q.split(lens), k.split(lens), v.split(lens))])
        del q, k, v
        x = fake_quant(x + linear(att, dense(w, "wo", li), bits, m.group),
                       resb, m.group)
        del att
        h = rms_norm(x, post_norm[li], m.eps)
        x = fake_quant(x + experts(w, li, h, bits), resb, m.group)
        del h
    rows, counts = wanted_rows(seqs)
    xr = rms_norm(x[torch.as_tensor(rows, device=device)],
                  w.norm("final_norm", stacked=False), m.eps)
    head_bits = torch.as_tensor(np.repeat([s.head_bits for s in seqs],
                                          counts), device=device)
    out = linear(xr, dense(w, "lm_head"), head_bits, m.group)[:, :m.vocab]
    return list(out.split(counts))
