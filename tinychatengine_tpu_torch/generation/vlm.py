"""VLM (LLaVA / VILA) pipeline: image → CLIP embeddings → the decoder's
prompt (counterpart of the JAX package's ``generation/vlm.py``).

- ``load_image``: decode a file with PIL (imported when called);
- ``encode_image``: pad, resize, normalise and run the CLIP tower and its
  projector (``models/clip.py``) to [576, mmproj_dim] bf16;
- ``build_multimodal_inputs``: the text's embedding-table rows with the
  image's embeddings spliced in at the ``<image>`` marker, the [1, S, E]
  ``input_embeds`` that ``Engine.prefill`` hands to ``llama.forward``;
- ``generate_with_image``: one turn through ``Engine.generate``.

Text rows are gathered from the table on its own device; the [V, E] table
never moves to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import GenerationConfig, ModelConfig
from tinychatengine_tpu_torch.generation.engine import Engine, GenerationResult
from tinychatengine_tpu_torch.models import clip

IMAGE_MARKER = "<image>"


def load_image(path: str) -> np.ndarray:
    """Decode an image file to uint8 [H, W, 3]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def encode_image(clip_params: clip.CLIPParams, clip_cfg: ModelConfig,
                 image) -> torch.Tensor:
    """uint8 [H, W, 3] → [n_patches, mmproj_dim] bf16 embeddings on the
    tower's device."""
    dev = clip_params.patch_embed.device
    pixels = clip.preprocess_image(image, clip_cfg.image_size, device=dev)
    return clip.encode_image(clip_params, clip_cfg, pixels[None])[0]


def _rows(embed_table: torch.Tensor, ids) -> torch.Tensor:
    """The table's rows ``ids`` as f32, gathered on the table's device."""
    idx = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                          device=embed_table.device)
    return embed_table[idx].float()


def build_multimodal_inputs(tok, embed_table: torch.Tensor, prompt: str,
                            image_embeds, bos: bool = True):
    """Split ``prompt`` at the ``<image>`` marker (without one the image
    comes first) and splice the image embeddings between the two text
    segments' table rows.

    Returns (input_ids [1, S] int32 numpy, input_embeds [1, S, E] bf16 on
    the table's device): the ids hold the text's tokens and 0 at the image
    positions (they feed only the sampler's penalty window and the
    shapes; the decoder reads the embeds)."""
    if IMAGE_MARKER in prompt:
        pre_text, post_text = prompt.split(IMAGE_MARKER, 1)
    else:
        pre_text, post_text = "", prompt
    pre = tok.encode(pre_text, bos=bos) if (pre_text or bos) else []
    post = tok.encode(post_text, bos=False)
    img = torch.as_tensor(image_embeds).to(embed_table.device).float()
    embeds = torch.cat([_rows(embed_table, pre), img,
                        _rows(embed_table, post)])
    ids = np.concatenate([np.asarray(pre, np.int32),
                          np.zeros((img.shape[0],), np.int32),
                          np.asarray(post, np.int32)])
    return ids[None, :], embeds.to(torch.bfloat16)[None]


def build_multimodal_inputs_multi(tok, embed_table: torch.Tensor, prompt: str,
                                  image_embeds_list, bos: bool = True):
    """The serving path's N-image splice: ``prompt`` holds one ``<image>``
    marker per entry of ``image_embeds_list``, in order; the text between
    markers is tokenized and embedded, each image's rows spliced in
    verbatim.

    Returns (ids [S] int32, embeds [S, E] float32), numpy both. The text
    rows come from one gather of just the rows needed, on the table's
    device."""
    segs = prompt.split(IMAGE_MARKER)
    if len(segs) != len(image_embeds_list) + 1:
        raise ValueError(
            f"prompt has {len(segs) - 1} image markers but "
            f"{len(image_embeds_list)} images were provided")
    ids_parts, spans = [], []   # spans: (offset, n_img) per image
    off = 0
    for si, seg in enumerate(segs):
        toks = tok.encode(seg, bos=(bos and si == 0)) \
            if (seg or (bos and si == 0)) else []
        ids_parts.append(np.asarray(toks, np.int32))
        off += len(toks)
        if si < len(image_embeds_list):
            n_img = image_embeds_list[si].shape[0]
            ids_parts.append(np.zeros((n_img,), np.int32))
            spans.append((off, n_img))
            off += n_img
    ids = np.concatenate(ids_parts)
    emb = _rows(embed_table, ids).cpu().numpy()
    for (o, n_img), img in zip(spans, image_embeds_list):
        emb[o:o + n_img] = torch.as_tensor(img).float().cpu().numpy()
    return ids, emb


def generate_with_image(engine: Engine, clip_params, clip_cfg: ModelConfig,
                        tok, prompt: str, image, gcfg: GenerationConfig,
                        stop_token_ids=(), on_token=None, cache=None,
                        image_embeds=None) -> GenerationResult:
    """One LLaVA-style turn: encode the image (unless its embeddings are
    given), splice, ``engine.generate``."""
    if image_embeds is None:
        image_embeds = encode_image(clip_params, clip_cfg, image)
    ids, embeds = build_multimodal_inputs(tok, engine.params.embed, prompt,
                                          image_embeds)
    return engine.generate(ids, gcfg, stop_token_ids=stop_token_ids,
                           on_token=on_token, cache=cache,
                           input_embeds=embeds)
