"""The llama family (``models/llama.py``: LLaMA, Mistral): RMSNorm, fused
q | k | v with grouped KV heads, RoPE, one sliding window for every layer,
SwiGLU with gate | up fused, an untied int4 lm_head padded to
``LMHEAD_PAD`` columns. Configuration keys: Hugging Face's llama /
Mistral names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from perfbench import work
from perfbench.model import Model, common

LMHEAD_PAD = 2048  # the int4 lm_head: N rounded up to this


@dataclasses.dataclass(frozen=True)
class Llama(Model):
    rope_theta: float = 10000.0
    window: Optional[int] = None

    @property
    def lm_head_cols(self) -> int:
        return -(-self.vocab // LMHEAD_PAD) * LMHEAD_PAD

    def linears(self) -> list:
        e, f, d = self.hidden, self.inter, self.head_dim
        return [("wqkv", e, (self.heads + 2 * self.kv_heads) * d, False),
                ("wo", self.heads * d, e, False),
                ("wgate_up", e, 2 * f, False),
                ("down", f, e, False)]

    def windows(self) -> list:
        return [self.window] * self.layers


def sizes(name: str, c: dict) -> Llama:
    return Llama(layers=c["num_hidden_layers"], hidden=c["hidden_size"],
                 inter=c["intermediate_size"],
                 heads=c["num_attention_heads"],
                 kv_heads=c["num_key_value_heads"], vocab=c["vocab_size"],
                 positions=c["max_position_embeddings"],
                 eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
                 window=c.get("sliding_window"), **common(name, c))


decode_call = work.dense_decode_call
prefill_call = work.dense_prefill_call


def port_config(m: Llama):
    from tinychatengine_tpu_torch.core.config import ModelConfig
    return ModelConfig(
        name=m.name, family="llama", num_heads=m.heads,
        num_kv_heads=m.kv_heads, num_layers=m.layers,
        max_sqlen=m.positions, embed_dim=m.hidden, hidden_dim=m.inter,
        vocab_size=m.vocab, rms_norm_eps=m.eps, rope_theta=m.rope_theta,
        sliding_window=m.window)


def port_quant(m: Llama, kv_cache_dtype: str):
    from tinychatengine_tpu_torch.core.config import QuantConfig
    return QuantConfig(scheme=m.scheme, group_size=m.group,
                       kv_cache_dtype=kv_cache_dtype, scale_dtype="bf16")


def fill(params, w) -> None:
    from perfbench import program
    m = w.model
    program.fill_linears(params, w)
    params.embed.copy_(w.table("embed", m.vocab))
    params.layers.input_norm.copy_(w.norm("input_norm"))
    params.layers.post_norm.copy_(w.norm("post_norm"))
    params.final_norm.copy_(w.norm("final_norm", stacked=False))


def build_params(w, max_pos: int):
    """``max_pos``: the RoPE table's length."""
    import torch

    from perfbench import program
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.ops import ref
    m, dev = w.model, w.device
    if m.lm_head_cols != llama.lmhead_padded(m.vocab):
        raise ValueError("the lm_head's padding differs from the port's")
    lins, head = program.int4_linears(w)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    stack = (m.layers, m.hidden)
    cos, sin = ref.make_rope_cache(m.head_dim, max_pos, m.rope_theta,
                                   device=dev)
    params = llama.LlamaParams(
        embed=torch.empty((m.vocab, m.hidden), **bf16),
        layers=llama.LlamaLayerParams(
            input_norm=torch.empty(stack, **bf16),
            post_norm=torch.empty(stack, **bf16), **lins),
        final_norm=torch.empty((m.hidden,), **bf16), lm_head=head,
        rope_cos=cos, rope_sin=sin)
    fill(params, w)
    return params


def forward(m: Llama):
    from tinychatengine_tpu_torch.models import llama
    return llama.forward
