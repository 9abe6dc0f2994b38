"""The GPTBigCode family (``models/gptbigcode.py``: StarCoder): learned
positions, LayerNorm with bias, multi-query attention with no window,
biased linears, tanh GELU, an untied int4 lm_head. Configuration keys:
Hugging Face's ``gpt_bigcode`` names.
"""

from __future__ import annotations

import dataclasses

from perfbench import work
from perfbench.model import Model, common


@dataclasses.dataclass(frozen=True)
class GPTBigCode(Model):
    def linears(self) -> list:
        e, f, d = self.hidden, self.inter, self.head_dim
        return [("c_attn", e, e + 2 * d, True), ("c_proj", e, e, True),
                ("fc_in", e, f, True), ("fc_out", f, e, True)]


def sizes(name: str, c: dict) -> GPTBigCode:
    return GPTBigCode(layers=c["n_layer"], hidden=c["n_embd"],
                      inter=c["n_inner"], heads=c["n_head"],
                      kv_heads=1 if c["multi_query"] else c["n_head"],
                      vocab=c["vocab_size"], positions=c["n_positions"],
                      eps=c["layer_norm_epsilon"], **common(name, c))


decode_call = work.dense_decode_call
prefill_call = work.dense_prefill_call


def port_config(m: GPTBigCode):
    from tinychatengine_tpu_torch.core.config import ModelConfig
    return ModelConfig(
        name=m.name, family="gptbigcode", num_heads=m.heads,
        num_kv_heads=m.kv_heads, num_layers=m.layers,
        max_sqlen=m.positions, embed_dim=m.hidden, hidden_dim=m.inter,
        vocab_size=m.vocab, rms_norm_eps=m.eps)


def port_quant(m: GPTBigCode, kv_cache_dtype: str):
    from tinychatengine_tpu_torch.core.config import QuantConfig
    return QuantConfig(scheme=m.scheme, group_size=m.group,
                       kv_cache_dtype=kv_cache_dtype, scale_dtype="bf16")


def fill(params, w) -> None:
    from perfbench import program
    m = w.model
    program.fill_linears(params, w)
    params.wte.copy_(w.table("wte", m.vocab))
    params.wpe.copy_(w.table("wpe", m.positions))
    for n in ("ln1", "ln2"):
        getattr(params.layers, f"{n}_w").copy_(w.norm(f"{n}_w"))
        getattr(params.layers, f"{n}_b").copy_(w.norm_bias(f"{n}_b"))
    params.lnf_w.copy_(w.norm("lnf_w", stacked=False))
    params.lnf_b.copy_(w.norm_bias("lnf_b", stacked=False))


def build_params(w, max_pos: int):
    """``max_pos`` is not used: the positions are learned."""
    import torch

    from perfbench import program
    from tinychatengine_tpu_torch.models import gptbigcode
    m, dev = w.model, w.device
    lins, head = program.int4_linears(w)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    stack = (m.layers, m.hidden)
    params = gptbigcode.GPTBigCodeParams(
        wte=torch.empty((m.vocab, m.hidden), **bf16),
        wpe=torch.empty((m.positions, m.hidden), **bf16),
        layers=gptbigcode.GPTBigCodeLayerParams(
            ln1_w=torch.empty(stack, **bf16),
            ln1_b=torch.empty(stack, **bf16),
            ln2_w=torch.empty(stack, **bf16),
            ln2_b=torch.empty(stack, **bf16), **lins),
        lnf_w=torch.empty((m.hidden,), **bf16),
        lnf_b=torch.empty((m.hidden,), **bf16), lm_head=head)
    fill(params, w)
    return params


def forward(m: GPTBigCode):
    from tinychatengine_tpu_torch.models import gptbigcode
    return gptbigcode.forward
