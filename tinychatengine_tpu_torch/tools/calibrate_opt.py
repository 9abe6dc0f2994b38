"""OPT W8A8 static quantization with activation calibration (counterpart of
the JAX package's ``tools/calibrate_opt.py``, without its command line).

Given fp OPT params and calibration token ids, it

1. runs the fp model and records each linear's input absmax (the static
   activation scales SmoothQuant needs), in torch on the params' device;
2. optionally migrates quantization difficulty from activations to
   weights (per-channel s_j = act_max_j^alpha / w_max_j^(1-alpha), folded
   into the preceding LayerNorm);
3. emits W8A8Linear params with the requant alphas composed as the
   Int8OPT kernels expect (y_s8 = clip(round(acc_i32 * A)),
   A = a_in * a_w / a_out), in numpy f32 with the JAX package's
   operations, so the int8 weights come out bit for bit the same.

Per-tensor scales, symmetric.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import ModelConfig
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.models import opt
from tinychatengine_tpu_torch.ops import ref
from tinychatengine_tpu_torch.ops.attention import NEG_INF
from tinychatengine_tpu_torch.ops.linear import W8A8Linear, apply_linear


def _absmax(x: torch.Tensor) -> float:
    return float(x.abs().max())


@torch.inference_mode()
def collect_activation_stats(params: opt.OPTParams, cfg: ModelConfig,
                             calib_ids: np.ndarray,
                             per_channel: bool = False) -> list:
    """Run the fp model over calibration ids and record the input ranges
    of every linear. Returns stats[layer_idx][name] -> absmax (a float, or
    a numpy [K] per channel for the LayerNorm outputs)."""
    dev = params.embed_tokens.device
    ids = torch.as_tensor(np.atleast_2d(np.asarray(calib_ids, np.int64)),
                          device=dev)
    b, s = ids.shape
    pos = torch.arange(s, device=dev)
    x = (params.embed_tokens[ids].float()
         + params.embed_positions[pos + opt.POS_OFFSET][None].float())

    def take(v):
        return (v.abs().amax(dim=(0, 1)).float().cpu().numpy()
                if per_channel else _absmax(v))

    lyr, d = params.layers, cfg.head_dim
    cache = kvc.init_cache(cfg.num_layers, b, s, cfg.num_kv_heads, d,
                           device=dev)
    causal = pos[None, :] <= pos[:, None]
    stats = []
    for i in range(cfg.num_layers):
        rec = {}
        h = ref.layer_norm_ref(x, lyr.attn_ln_w[i], lyr.attn_ln_b[i])
        rec["qkv_in"] = take(h)
        q, k, v = (apply_linear(p, h, layer_idx=i).reshape(b, s, -1, d)
                   for p in (lyr.q_proj, lyr.k_proj, lyr.v_proj))
        rec["q_out"], rec["k_out"], rec["v_out"] = (_absmax(q), _absmax(k),
                                                    _absmax(v))
        kvc.update_layer(cache, k, v, i, 0)
        ck, cv = kvc.read_layer(cache, i)  # bf16, as the JAX cache
        logits = torch.einsum("bshd,bhtd->bhst", q.float(),
                              ck.float()) / (d ** 0.5)
        logits = torch.where(causal[None, None], logits, NEG_INF)
        attn = torch.einsum("bhst,bhtd->bshd", torch.softmax(logits, -1),
                            cv.float()).reshape(b, s, -1)
        rec["attn_out"] = _absmax(attn)
        x = x + apply_linear(lyr.out_proj, attn, layer_idx=i).float()
        h2 = ref.layer_norm_ref(x, lyr.final_ln_w[i], lyr.final_ln_b[i])
        rec["fc1_in"] = take(h2)
        f = torch.clamp_min(apply_linear(lyr.fc1, h2, layer_idx=i), 0.0)
        rec["fc1_out"] = _absmax(f)
        x = x + apply_linear(lyr.fc2, f, layer_idx=i).float()
        stats.append(rec)
    return stats


def _quant_w(w: np.ndarray):
    """Per-tensor symmetric int8 weight quant: returns (w_s8 [K, N],
    scale)."""
    s = max(float(np.abs(w).max()) / 127.0, 1e-8)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


def quantize_opt_w8a8(params: opt.OPTParams, cfg: ModelConfig,
                      calib_ids: np.ndarray, smooth_alpha: float = 0.5,
                      device=None) -> opt.OPTParams:
    """fp OPTParams + calibration ids -> W8A8 OPTParams (LayerNormQ -> s8
    q/k/v -> s8 BMMs -> fp32 out_proj / fc2). smooth_alpha: SmoothQuant's
    migration strength (0 disables). ``device`` (the card by default; the
    params must lie there) runs the statistics pass and holds the
    result."""
    dev = resolve_device(device)
    stats = collect_activation_stats(params, cfg, calib_ids,
                                     per_channel=smooth_alpha > 0)

    def host(t) -> np.ndarray:  # a copy: the folds below work in place
        return t.float().cpu().numpy().copy()

    def dev_f32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def w8_s8out(w, bias, a_out, a_in_op):
        w8, a_w = _quant_w(w)
        return W8A8Linear(  # y = clip(round(acc * alpha + bias / a_out))
            weight=torch.from_numpy(w8).to(dev),
            alpha=dev_f32(a_in_op * a_w / a_out),
            bias=None if bias is None else dev_f32(bias / a_out))

    def w8_f32out(w, bias, a_in_op):
        w8, a_w = _quant_w(w)
        return W8A8Linear(weight=torch.from_numpy(w8).to(dev),
                          alpha=dev_f32(a_in_op * a_w),
                          bias=None if bias is None else dev_f32(bias))

    lyr = params.layers
    new_layers = []
    for i, rec in enumerate(stats):
        def at(t, i=i):
            return None if t is None else host(t[i])

        # --- smoothing: fold per-channel s into LN weights and q/k/v rows
        ln_w, ln_b = at(lyr.attn_ln_w), at(lyr.attn_ln_b)
        qw, kw, vw = (at(p.weight) for p in (lyr.q_proj, lyr.k_proj,
                                               lyr.v_proj))
        if smooth_alpha > 0:
            act_max = np.maximum(np.asarray(rec["qkv_in"], np.float32), 1e-5)
            w_max = np.maximum(
                np.max(np.abs(np.concatenate([qw, kw, vw], axis=1)), axis=1),
                1e-5)
            s_ch = np.clip(act_max ** smooth_alpha
                           / w_max ** (1 - smooth_alpha), 1e-3, 1e3)
            ln_w /= s_ch
            ln_b /= s_ch
            for w in (qw, kw, vw):
                w *= s_ch[:, None]
            a_in = float((act_max / s_ch).max()) / 127.0
        else:
            a_in = float(np.asarray(rec["qkv_in"])) / 127.0
        # the LayerNormQ output's activation scale, folded into the LN
        ln_w /= a_in
        ln_b /= a_in

        a_q = max(rec["q_out"], 1e-5) / 127.0
        a_k = max(rec["k_out"], 1e-5) / 127.0
        a_v = max(rec["v_out"], 1e-5) / 127.0
        a_attn = max(rec["attn_out"], 1e-5) / 127.0

        ln2_w, ln2_b = at(lyr.final_ln_w), at(lyr.final_ln_b)
        a_fc1_in = float(np.max(np.asarray(rec["fc1_in"]))) / 127.0
        ln2_w /= a_fc1_in
        ln2_b /= a_fc1_in
        a_fc1_out = max(rec["fc1_out"], 1e-5) / 127.0

        new_layers.append(opt.OPTLayerParams(
            attn_ln_w=dev_f32(ln_w), attn_ln_b=dev_f32(ln_b),
            q_proj=w8_s8out(qw, at(lyr.q_proj.bias), a_q, a_in),
            k_proj=w8_s8out(kw, at(lyr.k_proj.bias), a_k, a_in),
            v_proj=w8_s8out(vw, at(lyr.v_proj.bias), a_v, a_in),
            out_proj=w8_f32out(at(lyr.out_proj.weight),
                               at(lyr.out_proj.bias), a_attn),
            final_ln_w=dev_f32(ln2_w), final_ln_b=dev_f32(ln2_b),
            fc1=w8_s8out(at(lyr.fc1.weight), at(lyr.fc1.bias), a_fc1_out,
                         a_fc1_in),
            fc2=w8_f32out(at(lyr.fc2.weight), at(lyr.fc2.bias), a_fc1_out),
            # qk logits = q_s8 k_s8 * a_q a_k / sqrt(d)
            qk_alpha=dev_f32(a_q * a_k / (cfg.head_dim ** 0.5)),
            # pv: probs requantized x127; v in a_v units; out in a_attn s8
            pv_alpha=dev_f32((1.0 / 127.0) * a_v / a_attn)))
    return dataclasses.replace(params, layers=opt.stack_layers(new_layers))
