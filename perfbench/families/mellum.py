"""The Mellum family (Mellum2-12B-A2.5B through ``models/llama.py`` and
``models/moe.py``): RMSNorm, fused q | k | v with grouped KV heads and a
head width of its own (``head_dim``, not E / Hq), each layer its own window
and RoPE table (``layer_types``: a sliding layer the ``sliding_window`` at
default RoPE, a full one YaRN's, both at θ ``rope_theta``), and in every
layer a sparse-expert SwiGLU: a bf16 router over ``num_experts``, the
``num_experts_per_tok`` best renormalised (``norm_topk_prob``), each expert
an int4 gate | up (E -> 2 F) and down (F -> E) of width F =
``moe_intermediate_size``; an untied int4 lm_head. Configuration keys:
Hugging Face's Mellum names. Every int4 tensor is stored with its K
pack-padded to whole superblocks (``shape``; the down projection's 896 to
1024, every K at a CPU test's small widths), the pad rows meeting zero
activations; the work counts and the reference use the true K
(``linears``, ``true_k``).

Expert tensors are keyed (layer, expert). A call's work has three kernel
classes: ``linear`` (the attention projections and the lm_head),
``attention`` (each layer over its window) and ``expert`` (the routed
experts' weight bytes and operations: ``expert_bound``). Inside a run's
calls the experts a routing reads are counted as their expectation under
uniform routing over the real rows, E (1 - (1 - k / E)^rows) a layer; the
``expert`` metrics read the port's own counts instead (``serve.experts``
spans) through ``expert_bound``.
"""

from __future__ import annotations

import dataclasses

from perfbench import work
from perfbench.model import Model, common

LMHEAD_PAD = 2048   # the int4 lm_head: N rounded up to this
SUPERBLOCK = 256    # an int4 linear's K: whole superblocks
EXPERTS = ("experts_gate_up", "experts_down")

@dataclasses.dataclass(frozen=True)
class Mellum(Model):
    head_width: int = 128
    rope_theta: float = 500000.0
    layer_windows: tuple = ()
    layer_rope: tuple = ()
    yarn: tuple = ()        # (factor, original, beta_fast, beta_slow, attn)
    experts: int = 64
    top_k: int = 8
    expert_dim: int = 896
    norm_topk_prob: bool = True
    router_std: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.head_width

    @property
    def lm_head_cols(self) -> int:
        return -(-self.vocab // LMHEAD_PAD) * LMHEAD_PAD

    def linears(self) -> list:
        """The attention projections at their true K."""
        e, d = self.hidden, self.head_dim
        return [("wqkv", e, (self.heads + 2 * self.kv_heads) * d, False),
                ("wo", self.heads * d, e, False)]

    def true_k(self, name: str) -> int:
        if name == "experts_gate_up":
            return self.hidden
        if name == "experts_down":
            return self.expert_dim
        return super().shape(name)[0]

    def shape(self, name: str) -> tuple:
        """(stored K, N, bias) of an int4 tensor: K padded to whole
        superblocks."""
        if name == "experts_gate_up":
            n = 2 * self.expert_dim
        elif name == "experts_down":
            n = self.hidden
        else:
            n = super().shape(name)[1]
        return -(-self.true_k(name) // SUPERBLOCK) * SUPERBLOCK, n, False

    def windows(self) -> list:
        return list(self.layer_windows)

    def router(self, w, layer: int):
        """Layer ``layer``'s router [E, experts] bf16, N(0, router_std)."""
        import torch
        return (torch.randn((self.hidden, self.experts), device=w.device,
                            generator=w._gen("router", layer))
                * self.router_std).to(torch.bfloat16)


def sizes(name: str, c: dict) -> Mellum:
    rp = c["rope_parameters"]
    full, slide = rp["full_attention"], rp["sliding_attention"]
    if full["rope_type"] != "yarn" or slide["rope_type"] != "default" \
            or full["rope_theta"] != slide["rope_theta"]:
        raise ValueError("the family runs default RoPE on sliding layers and "
                         "YaRN on full ones at one theta")
    if any(t != "sparse" for t in c["mlp_layer_types"]):
        raise ValueError("the family runs sparse experts in every layer")
    kinds = c["layer_types"]
    return Mellum(layers=c["num_hidden_layers"], hidden=c["hidden_size"],
                  inter=c["intermediate_size"], heads=c["num_attention_heads"],
                  kv_heads=c["num_key_value_heads"], vocab=c["vocab_size"],
                  positions=c["max_position_embeddings"],
                  eps=c["rms_norm_eps"], head_width=c["head_dim"],
                  rope_theta=float(slide["rope_theta"]),
                  layer_windows=tuple(c["sliding_window"]
                                      if k == "sliding_attention" else None
                                      for k in kinds),
                  layer_rope=tuple("default" if k == "sliding_attention"
                                   else "yarn" for k in kinds),
                  yarn=(float(full["factor"]),
                        int(full["original_max_position_embeddings"]),
                        float(full["beta_fast"]), float(full["beta_slow"]),
                        float(full["attention_factor"])),
                  experts=c["num_experts"], top_k=c["num_experts_per_tok"],
                  expert_dim=c["moe_intermediate_size"],
                  norm_topk_prob=c["norm_topk_prob"],
                  router_std=c["assumed"]["router_std"], **common(name, c))


def expert_sets(m: Mellum) -> int:
    """The model's (layer, expert) weight sets: what the serving engine
    files as ``serve.engine`` b."""
    return m.layers * m.experts


def expert_bound(m: Mellum, sets: float, pairs: float, peaks: dict) -> float:
    """Roofline bound (s) of the expert matmuls that read ``sets``
    (layer, expert) weight sets for ``pairs`` routed (row, expert) pairs:
    gate | up and down each max(operations / bf16 peak, bytes / HBM rate),
    the weights at the published widths (K = F unpadded) read once a set,
    each pair's bf16 input read and output written once."""
    e, f, g = m.hidden, m.expert_dim, m.group
    t = 0.0
    for k, n in ((e, 2 * f), (f, e)):
        w = k * n / 2 + (k // g) * n * 2
        ops = 2.0 * pairs * k * n
        bytes_ = sets * w + pairs * (k + n) * 2
        t += max(ops / peaks["bf16_flops_s"], bytes_ / peaks["hbm_bytes_s"])
    return t


def expected_sets(m: Mellum, rows: int) -> float:
    """Experts a layer reads for ``rows`` rows under uniform routing."""
    return m.experts * (1.0 - (1.0 - m.top_k / m.experts) ** rows)


def _experts(m: Mellum, rows: int, peaks: dict) -> float:
    if rows <= 0:
        return 0.0
    return m.layers * expert_bound(m, expected_sets(m, rows),
                                   rows * m.top_k, peaks)


def decode_call(m: Mellum, kv_lens, peaks: dict, call_rows: int
                ) -> work.Bound:
    r = len(kv_lens)
    return work.Bound(linear=work.linears(m, r, r, peaks, call_rows),
                      attention=work.attention_decode(m, kv_lens, peaks),
                      expert=_experts(m, r, peaks))


def prefill_call(m: Mellum, chunks, head_rows: int, peaks: dict,
                 call_rows: int) -> work.Bound:
    rows = sum(t for _, t in chunks)
    return work.Bound(linear=work.linears(m, rows, head_rows, peaks,
                                          call_rows),
                      attention=work.attention_prefill(m, chunks, peaks),
                      expert=_experts(m, rows, peaks))


def port_config(m: Mellum):
    from tinychatengine_tpu_torch.core.config import ModelConfig, YarnRope
    factor, orig, fast, slow, attn = m.yarn
    return ModelConfig(
        name=m.name, family="llama", num_heads=m.heads,
        num_kv_heads=m.kv_heads, num_layers=m.layers,
        max_sqlen=m.positions, embed_dim=m.hidden, hidden_dim=m.inter,
        vocab_size=m.vocab, rms_norm_eps=m.eps, rope_theta=m.rope_theta,
        head_dim=m.head_dim, layer_windows=tuple(m.layer_windows),
        layer_rope=tuple(m.layer_rope),
        yarn=YarnRope(factor=factor, original_max_position_embeddings=orig,
                      beta_fast=fast, beta_slow=slow, attention_factor=attn),
        num_experts=m.experts, experts_per_tok=m.top_k,
        expert_dim=m.expert_dim, norm_topk_prob=m.norm_topk_prob)


def port_quant(m: Mellum, kv_cache_dtype: str):
    from tinychatengine_tpu_torch.core.config import QuantConfig
    return QuantConfig(scheme=m.scheme, group_size=m.group,
                       kv_cache_dtype=kv_cache_dtype, scale_dtype="bf16")


def fill(params, w) -> None:
    from perfbench import program
    m = w.model
    program.fill_linears(params, w)
    params.embed.copy_(w.table("embed", m.vocab))
    ly = params.layers
    ly.input_norm.copy_(w.norm("input_norm"))
    ly.post_norm.copy_(w.norm("post_norm"))
    params.final_norm.copy_(w.norm("final_norm", stacked=False))
    for li in range(m.layers):
        ly.router[li].copy_(m.router(w, li))
        for e in range(m.experts):
            i = li * m.experts + e
            for name in EXPERTS:
                lin = getattr(ly, name)
                w.packed(name, (li, e), out=lin.packed[i],
                         out_scales=lin.scales[i])


def build_params(w, max_pos: int):
    """``max_pos``: the RoPE tables' length."""
    import torch

    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.ops import ref
    from tinychatengine_tpu_torch.ops.linear import Int4Linear
    m, dev = w.model, w.device
    if m.lm_head_cols != llama.lmhead_padded(m.vocab):
        raise ValueError("the lm_head's padding differs from the port's")
    cfg = port_config(m)
    bf16 = dict(dtype=torch.bfloat16, device=dev)

    def stack(name, count=None):
        k, n, _ = m.shape(name)
        lead = () if count is None else (count,)
        return Int4Linear(
            packed=torch.empty(lead + (k // 2, n), dtype=torch.uint8,
                               device=dev),
            scales=torch.empty(lead + (k // m.group, n), **bf16))

    lins = {name: stack(name, m.layers) for name, *_ in m.linears()}
    experts = {name: stack(name, m.layers * m.experts) for name in EXPERTS}
    norms = (m.layers, m.hidden)
    cos, sin = ref.make_rope_cache(m.head_dim, max_pos, m.rope_theta,
                                   device=dev)
    ycos, ysin = ref.make_yarn_cache(m.head_dim, max_pos, m.rope_theta,
                                     cfg.yarn, device=dev)
    params = llama.LlamaParams(
        embed=torch.empty((m.vocab, m.hidden), **bf16),
        layers=llama.LlamaLayerParams(
            input_norm=torch.empty(norms, **bf16),
            post_norm=torch.empty(norms, **bf16),
            router=torch.empty((m.layers, m.hidden, m.experts), **bf16),
            **lins, **experts),
        final_norm=torch.empty((m.hidden,), **bf16),
        lm_head=stack("lm_head"),
        rope_cos=cos, rope_sin=sin, rope_cos_yarn=ycos, rope_sin_yarn=ysin)
    fill(params, w)
    return params


def forward(m: Mellum):
    from tinychatengine_tpu_torch.models import llama
    return llama.forward
