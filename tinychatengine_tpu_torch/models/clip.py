"""CLIP ViT-L/14-336 vision tower and the LLaVA mm_projector (counterpart of
the JAX package's ``models/clip.py``).

Patch embedding as a patchify reshape and one matmul (a 14 x 14 stride-14
convolution), class token and learned positions, a pre-LN transformer with
quick-GELU over the stacked [L, ...] layers, then the projector linear →
GELU → linear to the decoder's embed width: 576 patch embeddings that the
LLaMA decoder's prefill takes as ``input_embeds``
(``generation/vlm.py``).

The attention is bidirectional and plain: f32 logits times 1/sqrt(d), a
softmax, then the PV product, at the JAX function's cast points (no
attention kernel runs here, in either package). The f32 products must run
in f32 on the card: TF32 stays off (PyTorch's default).

``preprocess_image`` pads to a square and resizes bilinearly with the
weights ``jax.image.resize`` builds (``scale_and_translate``, which
antialiases when it shrinks), then normalises with CLIP's mean and std.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import ModelConfig
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.ops import ref
from tinychatengine_tpu_torch.ops.linear import DenseLinear, apply_linear
from tinychatengine_tpu_torch.quant.packing import numpy_to_torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class CLIPLayerParams:
    """All encoder layers, every leaf stacked [L, ...]."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    q_proj: DenseLinear
    k_proj: DenseLinear
    v_proj: DenseLinear
    out_proj: DenseLinear
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1: DenseLinear
    fc2: DenseLinear


@dataclasses.dataclass
class CLIPParams:
    patch_embed: torch.Tensor  # [patch*patch*3, E] (the conv kernel as a matmul)
    class_embed: torch.Tensor  # [E]
    pos_embed: torch.Tensor    # [1 + n_patches, E]
    pre_ln_w: torch.Tensor
    pre_ln_b: torch.Tensor
    layers: CLIPLayerParams    # stacked [L, ...]
    mm_proj_0: DenseLinear     # E -> mmproj_dim
    mm_proj_2: DenseLinear     # mmproj_dim -> mmproj_dim


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32: the bilinear (triangle) weights of
    ``jax.image.resize`` along one axis, antialiased when shrinking (the
    kernel widened by n_in / n_out), each column normalised, columns whose
    sample lies outside the input zeroed, at the jitted function's rounding:
    the division by the kernel width, a constant under jit, is a product
    by its f32 reciprocal (``ref.xla_recip``), and the sample position
    (i + 0.5) * inv - 0.5 is one fused multiply-add (rounded once, here
    through f64), as XLA's CPU code contracts it; one rounding more moves
    a sample near 255 by an f32 step, a weight by 4e-6."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kscale = max(inv, f32(1.0))
    half = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (half.astype(np.float64) * float(inv) - 0.5).astype(f32)
    x = (np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
         * f32(ref.xla_recip(kscale)))
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def preprocess_image(img, image_size: int = 336, device=None) -> torch.Tensor:
    """uint8 [H, W, 3] (numpy or a tensor) → normalised f32
    [image_size, image_size, 3] on ``device`` (a tensor's own device, else
    the card): zero-pad to a centred square, bilinear resize, scale to
    [0, 1], CLIP mean/std."""
    if isinstance(img, torch.Tensor):
        dev = img.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        img = torch.from_numpy(np.asarray(img))
    h, w, _ = img.shape
    side = max(h, w)
    x = torch.zeros((side, side, 3), dtype=torch.float32, device=dev)
    top, left = (side - h) // 2, (side - w) // 2
    x[top:top + h, left:left + w] = img.to(dev, torch.float32)
    if side != image_size:
        wt = torch.from_numpy(resize_weights(side, image_size)).to(dev)
        x = torch.einsum("hwc,hH->Hwc", x, wt)
        x = torch.einsum("Hwc,wW->HWc", x, wt)
    x = x / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=dev)
    return (x - mean) / std


def encode_image(params: CLIPParams, cfg: ModelConfig, pixels: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """pixels [B, 336, 336, 3] f32 (preprocessed) → image embeddings
    [B, n_patches, mmproj_dim] bf16 for the decoder's splice: the tower in
    ``dtype`` (bf16 by default; f32 is the reference tower), the class
    token dropped, then the projector in f32."""
    x = encode_hidden(params, cfg, pixels, dtype=dtype)
    y = apply_linear(params.mm_proj_0, x[:, 1:, :].float())
    y = ref.gelu_ref(y)
    y = apply_linear(params.mm_proj_2, y)
    return y.to(torch.bfloat16)


def encode_hidden(params: CLIPParams, cfg: ModelConfig, pixels: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """The tower's hidden states [B, 1 + n_patches, E] before the class
    token is dropped and the projector runs (HF CLIPVisionModel's last
    hidden state); matmuls take ``dtype`` operands and sum in f32."""
    b = pixels.shape[0]
    p, e = cfg.patch_size, cfg.embed_dim
    n_side = cfg.image_size // p
    x = pixels.reshape(b, n_side, p, n_side, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, n_side * n_side, p * p * 3)
    x = torch.matmul(x.to(dtype).float(),
                     params.patch_embed.to(dtype).float()).to(dtype)
    cls = params.class_embed.to(dtype).expand(b, 1, e)
    x = torch.cat([cls, x], dim=1)                      # [B, 577, E]
    x = x + params.pos_embed.to(dtype)[None]
    x = ref.layer_norm_ref(x, params.pre_ln_w, params.pre_ln_b).to(dtype)

    d = cfg.head_dim
    scale = 1.0 / (d ** 0.5)
    lyr = params.layers
    for li in range(cfg.num_layers):
        h = ref.layer_norm_ref(x, lyr.ln1_w[li], lyr.ln1_b[li]).to(dtype)
        n = h.shape[1]

        def heads(proj):  # [B, H, n, D] for the f32 products
            y = apply_linear(proj, h, layer_idx=li).reshape(b, n, -1, d)
            return y.permute(0, 2, 1, 3).float()
        q, k, v = heads(lyr.q_proj), heads(lyr.k_proj), heads(lyr.v_proj)
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
        probs = torch.softmax(logits, dim=-1)           # bidirectional
        attn = torch.matmul(probs.to(dtype).float(), v)  # [B, H, n, D]
        attn = attn.permute(0, 2, 1, 3).reshape(b, n, -1).to(x.dtype)
        x = x + apply_linear(lyr.out_proj, attn, layer_idx=li).to(x.dtype)
        h2 = ref.layer_norm_ref(x, lyr.ln2_w[li], lyr.ln2_b[li]).to(dtype)
        f = ref.quick_gelu_ref(
            apply_linear(lyr.fc1, h2, layer_idx=li).float())
        x = x + apply_linear(lyr.fc2, f.to(h2.dtype),
                             layer_idx=li).to(x.dtype)
    return x


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       device=None) -> CLIPParams:
    """Random f32 weights drawn with numpy in the JAX package's order, so
    one seed gives both packages the same tower."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    e, p = cfg.embed_dim, cfg.patch_size
    n_pos = 1 + (cfg.image_size // p) ** 2

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def dense(k, n):
        return normal((k, n), 0.02), normal(n, 0.01)

    names = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
    drawn = {nm: [] for nm in names}
    for _ in range(cfg.num_layers):
        for nm, (k, n) in zip(names, ((e, e),) * 4 + ((e, cfg.hidden_dim),
                                                      (cfg.hidden_dim, e))):
            drawn[nm].append(dense(k, n))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def stacked(nm):
        ws, bs = zip(*drawn.pop(nm))
        return DenseLinear(weight=t(np.stack(ws)), bias=t(np.stack(bs)))

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    nl = cfg.num_layers
    layers = CLIPLayerParams(
        ln1_w=ones(nl, e), ln1_b=zeros(nl, e), q_proj=stacked("q_proj"),
        k_proj=stacked("k_proj"), v_proj=stacked("v_proj"),
        out_proj=stacked("out_proj"), ln2_w=ones(nl, e),
        ln2_b=zeros(nl, e), fc1=stacked("fc1"), fc2=stacked("fc2"))
    patch_embed = t(normal((p * p * 3, e), 0.02))
    class_embed = t(normal(e, 0.02))
    pos_embed = t(normal((n_pos, e), 0.02))
    mm0 = DenseLinear(*(t(a) for a in dense(e, cfg.mmproj_dim)))
    mm2 = DenseLinear(*(t(a) for a in dense(cfg.mmproj_dim, cfg.mmproj_dim)))
    return CLIPParams(patch_embed=patch_embed, class_embed=class_embed,
                      pos_embed=pos_embed, pre_ln_w=ones(e),
                      pre_ln_b=zeros(e), layers=layers, mm_proj_0=mm0,
                      mm_proj_2=mm2)


def params_from_numpy(flat: dict, cfg: ModelConfig,
                      device=None) -> CLIPParams:
    """The port's tower from the checkpoint format's flat dict
    (``layers/q_proj/weight``, ``mm_proj_0/bias``, ...), on ``device``."""
    dev = resolve_device(device)

    def leaf(key):
        return numpy_to_torch(flat[key]).to(dev)

    def lin(prefix):
        return DenseLinear(weight=leaf(f"{prefix}/weight"),
                           bias=leaf(f"{prefix}/bias"))

    layers = CLIPLayerParams(
        **{f.name: (lin(f"layers/{f.name}") if f.type == "DenseLinear"
                    else leaf(f"layers/{f.name}"))
           for f in dataclasses.fields(CLIPLayerParams)})
    return CLIPParams(
        patch_embed=leaf("patch_embed"), class_embed=leaf("class_embed"),
        pos_embed=leaf("pos_embed"), pre_ln_w=leaf("pre_ln_w"),
        pre_ln_b=leaf("pre_ln_b"), layers=layers,
        mm_proj_0=lin("mm_proj_0"), mm_proj_2=lin("mm_proj_2"))
