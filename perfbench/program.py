"""The system under test: the port's parameters and entry points, built
from the benchmark's weights (``perfbench.weights``) and sizes by the
model's family (``families/<family>.py``: ``port_config``, ``port_quant``,
``build_params``, ``fill``, ``forward``). The only module of the
benchmark, with the drivers and the families' program side, that imports
the port, and that only inside its functions.
"""

from __future__ import annotations

import torch

from perfbench.model import Model, family
from perfbench.weights import Weights


def model_config(m: Model):
    """The port's ``ModelConfig`` for these sizes (the configuration file's
    published values; the registry's entry is not used)."""
    return family(m).port_config(m)


def quant_config(m: Model, kv_cache_dtype: str = "bf16"):
    return family(m).port_quant(m, kv_cache_dtype)


def build_params(w: Weights, max_pos: int):
    """The port's parameter tree of ``w.model``, filled from ``w``;
    ``max_pos``: the length of position tables the serving needs."""
    return family(w.model).build_params(w, max_pos)


def fill(params, w: Weights) -> None:
    """Write the seed's tensors into ``params`` in place (the buffers that
    captured graphs read stay where they are)."""
    family(w.model).fill(params, w)


def forward_fn(m: Model):
    return family(m).forward(m)


def int4_linears(w: Weights) -> tuple:
    """Empty port buffers of the model's int4 linears: ({name: every
    layer's linear in stacked [L, ...] buffers}, the lm_head), of the
    port's class for the scheme."""
    from tinychatengine_tpu_torch.ops.linear import Int4A8Linear, Int4Linear
    m, dev = w.model, w.device
    cls = Int4A8Linear if m.scheme == "w4a8" else Int4Linear
    lins = {}
    for name, k, n, bias in m.linears():
        lins[name] = cls(
            packed=torch.empty((m.layers, k // 2, n), dtype=torch.uint8,
                               device=dev),
            scales=torch.empty((m.layers, k // m.group, n),
                               dtype=torch.bfloat16, device=dev),
            bias=torch.empty((m.layers, n), device=dev) if bias else None)
    head = cls(packed=torch.empty((m.hidden // 2, m.lm_head_cols),
                                  dtype=torch.uint8, device=dev),
               scales=torch.empty((m.hidden // m.group, m.lm_head_cols),
                                  dtype=torch.bfloat16, device=dev))
    return lins, head


def fill_linears(params, w: Weights) -> None:
    """The seed's layer linears (``params.layers.<name>``) and lm_head
    (``params.lm_head``), in place."""
    m = w.model
    for name, _, _, bias in m.linears():
        lin = getattr(params.layers, name)
        for li in range(m.layers):
            w.packed(name, li, out=lin.packed[li], out_scales=lin.scales[li])
        if bias:
            lin.bias.copy_(w.bias(name))
    w.packed("lm_head", out=params.lm_head.packed,
             out_scales=params.lm_head.scales)


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
