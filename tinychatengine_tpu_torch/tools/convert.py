"""Requantize an fp llama into int4 QM_TPU weights (counterpart of
``quantize_linear`` and ``requantize_llama`` in the JAX package's
``tools/convert.py``). The quantizer and packer are bit-exact copies, so the
packed bytes equal the JAX package's for the same fp weights."""

from __future__ import annotations

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import QuantConfig
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.models.llama import LlamaLayerParams, LlamaParams
from tinychatengine_tpu_torch.ops.linear import DenseLinear, quantized_linear


def quantize_linear(w_oc_ic: np.ndarray, qcfg: QuantConfig, device=None):
    """w [OC, IC] float → Int4Linear, or Int4A8Linear for w4a8 (QM_TPU), on
    ``device`` (``None``: the card, raising without one)."""
    if qcfg.scheme not in ("w4a16", "w4a8"):
        raise ValueError(f"no int4 layout for scheme {qcfg.scheme!r}")
    return quantized_linear(w_oc_ic, qcfg.group_size, qcfg.scale_dtype,
                            a8=qcfg.scheme == "w4a8",
                            device=resolve_device(device))


def requantize_llama(params: LlamaParams, qcfg: QuantConfig) -> LlamaParams:
    """fp LlamaParams → w4a16 / w4a8 LlamaParams on the same device, with
    conversion-time numerics. Groups run along K per output column, so
    quantizing the fused qkv / gate-up matrices equals quantizing before
    fusion."""
    if qcfg.scheme == "fp":
        return params
    dev = params.embed.device
    lyr = params.layers

    def qlin(w: torch.Tensor):
        return quantize_linear(w.float().cpu().numpy().T, qcfg, device=dev)

    def qlin_stacked(p):
        per = [qlin(w) for w in p.weight]
        return type(per[0])(packed=torch.stack([x.packed for x in per]),
                            scales=torch.stack([x.scales for x in per]))

    for p in (lyr.wqkv, lyr.wo, lyr.wgate_up, lyr.down, params.lm_head):
        if not isinstance(p, DenseLinear) or p.bias is not None:
            raise ValueError("requantize expects a bias-free fp llama tree")

    return LlamaParams(
        embed=params.embed,
        layers=LlamaLayerParams(
            input_norm=lyr.input_norm, wqkv=qlin_stacked(lyr.wqkv),
            wo=qlin_stacked(lyr.wo), post_norm=lyr.post_norm,
            wgate_up=qlin_stacked(lyr.wgate_up), down=qlin_stacked(lyr.down)),
        final_norm=params.final_norm,
        lm_head=qlin(params.lm_head.weight),
        rope_cos=params.rope_cos, rope_sin=params.rope_sin)
