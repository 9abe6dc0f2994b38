"""Load a ``tinychatengine_tpu.v1`` llama, opt or gptbigcode checkpoint into
the port (counterpart of the JAX package's ``tools/checkpoint.py`` loader).

The format is ``meta.json`` (model and quant config, a ``dtypes`` map) plus
``shard_*.npz`` files of the flattened parameter tree keyed by tree path
(``layers/wqkv/packed`` stored as ``layers|wqkv|packed``). bf16 leaves are
stored as their uint16 bit patterns and become ``torch.bfloat16`` tensors
here without a round trip through float; int8 (W8A8 weights), uint8
(packed int4) and f32 leaves are stored as themselves.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tinychatengine_tpu_torch.core.config import (ModelConfig, QuantConfig,
                                                  get_model_config)
from tinychatengine_tpu_torch.models import gptbigcode, llama, opt
from tinychatengine_tpu_torch.quant.packing import from_bf16_bits


def read_flat(path: str) -> tuple[dict, dict]:
    """(meta, flat dict key -> numpy array or bf16 torch tensor)."""
    meta = json.loads((Path(path) / "meta.json").read_text())
    assert meta.get("format", "").startswith("tinychatengine_tpu"), meta
    dtypes = meta.get("dtypes", {})
    flat = {}
    for fname in sorted(set(meta["index"].values())):
        with np.load(Path(path) / fname) as z:
            for k in z.files:
                key = k.replace("|", "/")
                v = z[k]
                if key in dtypes:
                    if dtypes[key] != "bfloat16":
                        raise NotImplementedError(
                            f"{key}: stored dtype {dtypes[key]}")
                    v = from_bf16_bits(v.view(np.uint16))
                flat[key] = v
    return meta, flat


def load_checkpoint(path: str, cfg: ModelConfig | None = None,
                    device=None):
    """Returns (``LlamaParams``, ``OPTParams`` or ``GPTBigCodeParams`` on
    ``device``, qcfg); ``device`` defaults to the card and raises when there
    is none."""
    meta, flat = read_flat(path)
    cfg = cfg or get_model_config(meta["model"])
    family = meta.get("family") or cfg.family
    models = {"llama": llama, "opt": opt, "gptbigcode": gptbigcode}
    if family not in models:
        raise NotImplementedError(f"the port loads {sorted(models)} "
                                  f"checkpoints, not {family!r}")
    q = meta["quant"]
    qcfg = QuantConfig(scheme=q["scheme"], group_size=q["group_size"],
                       kv_cache_dtype=q.get("kv_cache_dtype", "bf16"))
    return models[family].params_from_numpy(flat, cfg, qcfg, device), qcfg
