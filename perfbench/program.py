"""The system under test: the port's parameters and entry points, built
from the benchmark's weights (``perfbench.weights``) and sizes. The only
module of the benchmark, with the drivers, that imports the port.
"""

from __future__ import annotations

import torch

from perfbench.model import Model
from perfbench.weights import Weights


def model_config(m: Model):
    """The port's ``ModelConfig`` for these sizes (the configuration file's
    published values; the registry's entry is not used)."""
    from tinychatengine_tpu_torch.core.config import ModelConfig
    return ModelConfig(
        name=m.name, family=m.family, num_heads=m.heads,
        num_kv_heads=m.kv_heads, num_layers=m.layers,
        max_sqlen=m.positions, embed_dim=m.hidden, hidden_dim=m.inter,
        vocab_size=m.vocab, rms_norm_eps=m.eps,
        rope_theta=m.rope_theta or 10000.0, sliding_window=m.window)


def quant_config(m: Model, kv_cache_dtype: str = "bf16"):
    from tinychatengine_tpu_torch.core.config import QuantConfig
    return QuantConfig(scheme=m.scheme, group_size=m.group,
                       kv_cache_dtype=kv_cache_dtype, scale_dtype="bf16")


def _stacked_linear(w: Weights, name: str, cls, bias: bool):
    """One layer linear of every layer in stacked [L, ...] buffers."""
    m = w.model
    k, n = next((k, n) for nm, k, n, _ in m.linears() if nm == name)
    dev = w.device
    packed = torch.empty((m.layers, k // 2, n), dtype=torch.uint8, device=dev)
    scales = torch.empty((m.layers, k // m.group, n), dtype=torch.bfloat16,
                         device=dev)
    lin = cls(packed=packed, scales=scales,
              bias=torch.empty((m.layers, n), device=dev) if bias else None)
    return lin


def fill(params, w: Weights) -> None:
    """Write the seed's tensors into ``params`` in place (the buffers that
    captured graphs read stay where they are)."""
    m = w.model
    for name, _, _, bias in m.linears():
        lin = getattr(params.layers, name)
        for li in range(m.layers):
            w.packed(name, li, out=lin.packed[li], out_scales=lin.scales[li])
        if bias:
            lin.bias.copy_(w.bias(name))
    w.packed("lm_head", out=params.lm_head.packed,
             out_scales=params.lm_head.scales)
    if m.family == "llama":
        params.embed.copy_(w.table("embed", m.vocab))
        params.layers.input_norm.copy_(w.norm("input_norm"))
        params.layers.post_norm.copy_(w.norm("post_norm"))
        params.final_norm.copy_(w.norm("final_norm", stacked=False))
    else:
        params.wte.copy_(w.table("wte", m.vocab))
        params.wpe.copy_(w.table("wpe", m.positions))
        for n in ("ln1", "ln2"):
            getattr(params.layers, f"{n}_w").copy_(w.norm(f"{n}_w"))
            getattr(params.layers, f"{n}_b").copy_(w.norm_bias(f"{n}_b"))
        params.lnf_w.copy_(w.norm("lnf_w", stacked=False))
        params.lnf_b.copy_(w.norm_bias("lnf_b", stacked=False))


def build_params(w: Weights, max_pos: int):
    """The port's parameter tree of ``w.model``, filled from ``w``;
    ``max_pos``: the llama family's RoPE table length."""
    from tinychatengine_tpu_torch.models import gptbigcode, llama
    from tinychatengine_tpu_torch.ops import ref
    from tinychatengine_tpu_torch.ops.linear import Int4A8Linear, Int4Linear
    m, dev = w.model, w.device
    cls = Int4A8Linear if m.scheme == "w4a8" else Int4Linear
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    lins = {n: _stacked_linear(w, n, cls, b) for n, _, _, b in m.linears()}
    head = cls(packed=torch.empty((m.hidden // 2, m.lm_head_cols),
                                  dtype=torch.uint8, device=dev),
               scales=torch.empty((m.hidden // m.group, m.lm_head_cols),
                                  **bf16))
    stack = (m.layers, m.hidden)
    if m.family == "llama":
        if m.lm_head_cols != llama.lmhead_padded(m.vocab):
            raise ValueError("the lm_head's padding differs from the port's")
        cos, sin = ref.make_rope_cache(m.head_dim, max_pos, m.rope_theta,
                                       device=dev)
        params = llama.LlamaParams(
            embed=torch.empty((m.vocab, m.hidden), **bf16),
            layers=llama.LlamaLayerParams(
                input_norm=torch.empty(stack, **bf16),
                post_norm=torch.empty(stack, **bf16), **lins),
            final_norm=torch.empty((m.hidden,), **bf16), lm_head=head,
            rope_cos=cos, rope_sin=sin)
    else:
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


def forward_fn(m: Model):
    from tinychatengine_tpu_torch.generation.engine import forward_for_family
    return forward_for_family(m.family)


def generation_config(fields: dict, seed: int):
    """The port's ``GenerationConfig`` with ``fields`` over its defaults."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    return GenerationConfig(**{**fields, "seed": int(seed)})


def build_kernels(device) -> None:
    """Compile (or find built) every CUDA source of the port at once, in
    the checkout's build directory."""
    if torch.device(device).type == "cuda":
        from tinychatengine_tpu_torch.ops import _build
        _build.build_all()


def launches() -> dict:
    """The port's launch counter: kernel name -> launches on the card so
    far in this process (a captured graph's at every replay)."""
    from tinychatengine_tpu_torch.ops import _build
    return dict(_build.LAUNCHES)
