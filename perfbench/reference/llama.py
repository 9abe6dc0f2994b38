"""Plain f32 reference of the llama / Mistral decoder (Hugging Face's
``MistralForCausalLM`` equations): token embedding; per layer RMSNorm,
fused q | k | v projection (head-major columns), rotate-half RoPE at
``rope_theta``, causal attention with grouped KV heads and the sliding
window, output projection, residual, RMSNorm, SiLU(gate) * up with gate |
up fused (gate first), down projection, residual; final RMSNorm and the
lm_head (its columns past the vocabulary dropped). Weights come from
``perfbench.weights`` for the run's seed, one layer at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.common import (attention, fake_quant, kv_quant,
                                        linear, row_bits_tensor,
                                        wanted_rows)
from perfbench.weights import Weights


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [T, H, D] at positions [T] (angles in f64)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = pos.double()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


@torch.inference_mode()
def logits(w: Weights, seqs: list, device) -> list:
    """Logits [len(want), V] f32 of each ``Seq`` at its wanted positions."""
    m = w.model
    d, hq, hkv, e = m.head_dim, m.heads, m.kv_heads, m.hidden
    bits = row_bits_tensor(seqs, device)
    kvb, resb = seqs[0].kv_bits, seqs[0].res_bits
    ids = torch.as_tensor(np.concatenate([s.ids for s in seqs]),
                          device=device)
    x = w.table("embed", m.vocab)[ids].float()
    del ids
    lens = [len(s.ids) for s in seqs]
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    in_norm, post_norm = w.norm("input_norm"), w.norm("post_norm")
    for li in range(m.layers):
        h = rms_norm(x, in_norm[li], m.eps)
        qkv = linear(h, w.dense("wqkv", li), bits, m.group)
        q = rope(qkv[:, :hq * d].reshape(-1, hq, d), pos, m.rope_theta)
        k = rope(qkv[:, hq * d:(hq + hkv) * d].reshape(-1, hkv, d), pos,
                 m.rope_theta)
        v = qkv[:, (hq + hkv) * d:].reshape(-1, hkv, d)
        del qkv, h
        k, v = kv_quant(k, kvb), kv_quant(v, kvb)
        att = torch.cat([attention(qs, ks, vs, m.window) for qs, ks, vs in
                         zip(q.split(lens), k.split(lens), v.split(lens))])
        del q, k, v
        x = fake_quant(x + linear(att, w.dense("wo", li), bits, m.group),
                       resb, m.group)
        del att
        h = rms_norm(x, post_norm[li], m.eps)
        gu = linear(h, w.dense("wgate_up", li), bits, m.group)
        act = torch.nn.functional.silu(gu[:, :m.inter]) * gu[:, m.inter:]
        del gu, h
        x = fake_quant(x + linear(act, w.dense("down", li), bits, m.group),
                       resb, m.group)
        del act
    rows, counts = wanted_rows(seqs)
    xr = rms_norm(x[torch.as_tensor(rows, device=device)],
                  w.norm("final_norm", stacked=False), m.eps)
    head_bits = torch.as_tensor(np.repeat([s.head_bits for s in seqs],
                                          counts), device=device)
    out = linear(xr, w.dense("lm_head"), head_bits, m.group)[:, :m.vocab]
    return list(out.split(counts))
