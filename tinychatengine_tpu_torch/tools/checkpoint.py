"""Save and load ``tinychatengine_tpu.v1`` llama, opt, gptbigcode and clip
checkpoints (counterpart of the JAX package's ``tools/checkpoint.py``); a
VLM's vision tower is a ``clip`` checkpoint of its own in ``<ckpt>/clip``
(``save_clip``, ``load_clip``); ``load_tokenizer`` finds the tokenizer
beside a checkpoint.

The format is ``meta.json`` (model and quant config, a ``dtypes`` map) plus
``shard_*.npz`` files of the flattened parameter tree keyed by tree path
(``layers/wqkv/packed`` stored as ``layers|wqkv|packed``). bf16 leaves are
stored as their uint16 bit patterns and become ``torch.bfloat16`` tensors
here without a round trip through float; int8 (W8A8 weights), uint8
(packed int4) and f32 leaves are stored as themselves. ``save_checkpoint``
writes what the JAX package writes for the same tree: the same keys,
shards, ``meta.json`` and array bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import (ModelConfig, QuantConfig,
                                                  config_dict,
                                                  get_model_config)
from tinychatengine_tpu_torch.models import clip, gptbigcode, llama, opt
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
    """Returns (``LlamaParams``, ``OPTParams``, ``GPTBigCodeParams`` or
    ``CLIPParams`` on ``device``, qcfg); ``device`` defaults to the card and
    raises when there is none."""
    meta, flat = read_flat(path)
    if cfg is None:
        cfg = (ModelConfig(**meta["clip_cfg"]) if "clip_cfg" in meta
               else get_model_config(meta["model"]))
    family = meta.get("family") or cfg.family
    models = {"llama": llama, "opt": opt, "gptbigcode": gptbigcode,
              "clip": clip}
    if family not in models:
        raise NotImplementedError(f"the port loads {sorted(models)} "
                                  f"checkpoints, not {family!r}")
    q = meta["quant"]
    qcfg = QuantConfig(scheme=q["scheme"], group_size=q["group_size"],
                       kv_cache_dtype=q.get("kv_cache_dtype", "bf16"))
    if family == "clip":
        return clip.params_from_numpy(flat, cfg, device), qcfg
    return models[family].params_from_numpy(flat, cfg, qcfg, device), qcfg


_SHARD_BYTES = 1 << 30  # ~1 GB per npz shard, as in the JAX package


def flatten(params) -> dict:
    """A parameter tree of dataclasses as the format's flat dict: tree path
    (field names joined by ``/``) -> tensor; None leaves are absent."""
    out = {}

    def walk(p, prefix):
        if p is None:
            return
        if isinstance(p, torch.Tensor):
            out[prefix] = p
            return
        for f in dataclasses.fields(p):
            walk(getattr(p, f.name), f"{prefix}/{f.name}" if prefix
                 else f.name)
    walk(params, "")
    return out


def _stored(t: torch.Tensor) -> np.ndarray:
    """A leaf as the npz stores it: C-ordered, bf16 as its uint16 bits."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(path: str, params, cfg: ModelConfig, qcfg: QuantConfig,
                    extra_meta: dict | None = None) -> None:
    """Write ``params`` (on any device) as a ``tinychatengine_tpu.v1``
    checkpoint: sorted keys in ~1 GB ``shard_*.npz`` files, ``meta.json``
    with the model name, the quant config, the key -> shard index and the
    bf16 leaves' ``dtypes``."""
    os.makedirs(path, exist_ok=True)
    flat = flatten(params)
    shards: list[dict] = [{}]
    size = 0
    for k in sorted(flat):
        if size > _SHARD_BYTES:
            shards.append({})
            size = 0
        shards[-1][k] = flat[k]
        size += flat[k].numel() * flat[k].element_size()
    index, dtypes = {}, {}
    for i, shard in enumerate(shards):
        fname = f"shard_{i:04d}.npz"
        enc = {}
        for k, t in shard.items():
            if t.dtype == torch.bfloat16:
                dtypes[k] = "bfloat16"
            enc[k.replace("/", "|")] = _stored(t)
        np.savez(Path(path) / fname, **enc)
        for k in shard:
            index[k] = fname
    meta = {
        "dtypes": dtypes,
        "format": "tinychatengine_tpu.v1",
        "model": cfg.name,
        "quant": {"scheme": qcfg.scheme, "group_size": qcfg.group_size,
                  "kv_cache_dtype": qcfg.kv_cache_dtype},
        "index": index,
        **(extra_meta or {}),
    }
    (Path(path) / "meta.json").write_text(json.dumps(meta, indent=1))


def save_clip(path: str, clip_params, clip_cfg: ModelConfig) -> None:
    """Write a VLM's vision tower as the ``clip`` checkpoint
    ``<path>/clip`` (f32 leaves, ``clip_cfg`` in its ``meta.json``)."""
    save_checkpoint(str(Path(path) / "clip"), clip_params, clip_cfg,
                    QuantConfig(scheme="fp"),
                    extra_meta={"family": "clip",
                                "clip_cfg": config_dict(clip_cfg)})


def load_clip(path: str, device=None):
    """(``CLIPParams`` on ``device``, its ModelConfig) from
    ``<path>/clip``."""
    sub = Path(path) / "clip"
    meta = json.loads((sub / "meta.json").read_text())
    cfg = ModelConfig(**meta["clip_cfg"])
    params, _ = load_checkpoint(str(sub), cfg, device)
    return params, cfg


def load_tokenizer(path: str, cfg: ModelConfig):
    """Best-effort tokenizer discovery in a checkpoint/tokenizer directory
    (the JAX package's rules): a file, or the directory's ``tokenizer.*``
    and ``*vocab*`` entries, read as Llama-3 BPE for llama3 models (or any
    vocabulary above 100000), SentencePiece for the llama family and
    byte-level BPE otherwise; the byte tokenizer when none loads."""
    from tinychatengine_tpu_torch.tokenizers import (ByteLevelBPE, Llama3BPE,
                                                     SentencePieceBPE)
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import (
        ByteTokenizer)

    p = Path(path)
    candidates = [p] if p.is_file() else list(p.glob("tokenizer.*")) + \
        list(p.glob("*vocab*"))
    for c in candidates:
        try:
            if "llama3" in cfg.name or cfg.vocab_size > 100000:
                return Llama3BPE.load(str(c))
            if cfg.family == "llama":
                return SentencePieceBPE.load(str(c))
            return ByteLevelBPE.load(str(c if c.is_dir() else c.parent))
        except Exception:
            continue
    return ByteTokenizer()
