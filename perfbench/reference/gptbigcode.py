"""Plain f32 reference of the GPTBigCode (StarCoder) decoder (Hugging
Face's ``GPTBigCodeForCausalLM`` equations, multi-query): token plus
learned position embeddings; per layer LayerNorm with bias, c_attn with
bias giving q (n_head heads) | one k head | one v head, causal attention
scaled by 1 / sqrt(head_dim), c_proj with bias, residual, LayerNorm,
fc_in with bias, tanh-approximated GELU, fc_out with bias, residual; final
LayerNorm and the lm_head. Weights come from ``perfbench.weights`` for the
run's seed, one layer at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.common import (attention, fake_quant, kv_quant,
                                        linear, row_bits_tensor,
                                        wanted_rows)
from perfbench.weights import Weights


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


@torch.inference_mode()
def logits(w: Weights, seqs: list, device) -> list:
    """Logits [len(want), V] f32 of each ``Seq`` at its wanted positions."""
    m = w.model
    d, hq, e = m.head_dim, m.heads, m.hidden
    bits = row_bits_tensor(seqs, device)
    kvb, resb = seqs[0].kv_bits, seqs[0].res_bits
    ids = torch.as_tensor(np.concatenate([s.ids for s in seqs]),
                          device=device)
    lens = [len(s.ids) for s in seqs]
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    x = (w.table("wte", m.vocab)[ids].float()
         + w.table("wpe", m.positions)[pos].float())
    del ids, pos
    ln1_w, ln1_b = w.norm("ln1_w"), w.norm_bias("ln1_b")
    ln2_w, ln2_b = w.norm("ln2_w"), w.norm_bias("ln2_b")
    bias = {n: w.bias(n) for n, *_ in m.linears()}
    for li in range(m.layers):
        h = layer_norm(x, ln1_w[li], ln1_b[li], m.eps)
        qkv = linear(h, w.dense("c_attn", li), bits, m.group,
                     bias["c_attn"][li])
        q = qkv[:, :e].reshape(-1, hq, d)
        k = qkv[:, e:e + d].reshape(-1, 1, d)
        v = qkv[:, e + d:].reshape(-1, 1, d)
        del qkv, h
        k, v = kv_quant(k, kvb), kv_quant(v, kvb)
        att = torch.cat([attention(qs, ks, vs) for qs, ks, vs in
                         zip(q.split(lens), k.split(lens), v.split(lens))])
        del q, k, v
        x = fake_quant(x + linear(att, w.dense("c_proj", li), bits, m.group,
                                  bias["c_proj"][li]), resb, m.group)
        del att
        h = layer_norm(x, ln2_w[li], ln2_b[li], m.eps)
        f = torch.nn.functional.gelu(
            linear(h, w.dense("fc_in", li), bits, m.group, bias["fc_in"][li]),
            approximate="tanh")
        del h
        x = fake_quant(x + linear(f, w.dense("fc_out", li), bits, m.group,
                                  bias["fc_out"][li]), resb, m.group)
        del f
    rows, counts = wanted_rows(seqs)
    xr = layer_norm(x[torch.as_tensor(rows, device=device)],
                    w.norm("lnf_w", stacked=False),
                    w.norm_bias("lnf_b", stacked=False), m.eps)
    head_bits = torch.as_tensor(np.repeat([s.head_bits for s in seqs],
                                          counts), device=device)
    out = linear(xr, w.dense("lm_head"), head_bits, m.group)[:, :m.vocab]
    return list(out.split(counts))
