"""AWQ — activation-aware weight-quantization scale search (counterpart of
the JAX package's ``quant/awq.py``).

Salient input channels get per-channel scales s = E[|x|]^alpha, alpha
grid-searched per linear to minimise the int4-quantized output MSE on
calibration activations (Lin et al., MLSys'24 §3), and the winning scales
are folded exactly into the op that produces each linear's input:

    qkv      <- input RMSNorm weight      (norm_w / s, W rows * s)
    gate_up  <- post RMSNorm weight
    wo       <- v-projection columns      (GQA: one scale per v channel,
                shared across the query heads that read it)
    down     <- up-projection columns     (down input = silu(g) * u is
                linear in u)
    lm_head  <- final RMSNorm weight

so the kernels, layouts and checkpoints are untouched: quantize the
returned tree (``tools.convert.requantize_llama``).

The search's arithmetic is the JAX package's eager numpy, its dtypes
written out so no numpy promotion rule decides them: s_base and each
grid point's s in numpy on the host (s_base ** alpha in f32, the
normalisation and the clip in f64), the weight scaled in f64 and rounded
to f32 for the quantizer, the dequantized weight divided by s in f64,
``x @ wq`` in f64, ``y_ref = x @ w`` in f32, the loss in f64. On the CPU the
products run in numpy as the JAX package runs them; on the card the
quantizer and the products run in torch (``_losses_torch``: the f64
products on the FP64 tensor cores, y_ref in f32 with TF32 off), and the
chosen s is the host's, so it is the JAX package's bit for bit wherever
the chosen alpha is.

The calibration forward (``calibration_layers``) runs the fp model one
layer at a time with the forward's ops; its attention is
``ops.attention.flash_prefill`` (the kernel on the card, the plain version
on the CPU). The calibration runs the *original* model, so layer i's
activations do not depend on layer i's search: ``awq_scale_llama`` keeps
one layer's activations live at a time and gives the numbers the JAX
package's all-layers dictionary gives.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.ops import ref
from tinychatengine_tpu_torch.ops.attention import flash_prefill
from tinychatengine_tpu_torch.ops.linear import DenseLinear, apply_linear
from tinychatengine_tpu_torch.quant.numerics import (
    dequantize_groupwise_int4,
    dequantize_groupwise_int4_kn,
    quantize_groupwise_int4,
    quantize_groupwise_int4_kn,
)

DEFAULT_GRID = 20
SITES = ("qkv", "wo", "gate_up", "down")
# weight columns a step of the card's search holds at once (its products
# and quantizer run over [K, LOSS_CHUNK] slices; groups run along K)
LOSS_CHUNK = 8192
# the host's search runs its grid points on up to HOST_THREADS threads
# (numpy's large-array loops release the GIL), as many as HOST_BYTES holds
# at about four f64 copies of the weight a point
HOST_THREADS = 8
HOST_BYTES = 4 << 30


# ---------------------------------------------------------------------------
# calibration: each linear's INPUT activations from the fp model
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibration_layers(params, cfg, ids):
    """Run the fp LLaMA-family model on ``ids`` [B, S] (a full prefill from
    position 0, no cache) on the params' device, one layer at a time.
    Yields, per layer, ``{"qkv": [N, E], "wo": [N, Hq*D], "gate_up": [N,
    E], "down": [N, F]}`` (N = B*S rows, f32 tensors on that device), then
    ``{"lm_head": [N, E]}``.

    The forward's math: rms_norm_ref, the dense linears, apply_rotary, and
    causal attention through ``flash_prefill`` (``cfg.sliding_window``)
    over a one-layer cache that holds the batch's keys."""
    dev = params.embed.device
    ids = torch.as_tensor(np.atleast_2d(np.asarray(ids, np.int64)),
                          device=dev)
    b, s = ids.shape
    d, eps = cfg.head_dim, cfg.rms_norm_eps
    ratio = cfg.num_heads // cfg.num_kv_heads
    x = params.embed[ids].to(torch.bfloat16)
    pos = torch.arange(s, device=dev)
    cos = params.rope_cos[pos].float()[None].expand(b, s, d)
    sin = params.rope_sin[pos].float()[None].expand(b, s, d)

    def rows(a):  # [B, S, C] -> [B*S, C] f32
        return a.float().reshape(-1, a.shape[-1])

    lyr = params.layers
    for i in range(lyr.wqkv.weight.shape[0]):
        h = ref.rms_norm_ref(x, lyr.input_norm[i], eps)
        qkv = apply_linear(lyr.wqkv, h, layer_idx=i)
        hkv = qkv.shape[-1] // (d * (ratio + 2))
        hq = ratio * hkv
        q = qkv[..., :hq * d].reshape(b, s, hq, d)
        k = qkv[..., hq * d:(hq + hkv) * d].reshape(b, s, hkv, d)
        v = qkv[..., (hq + hkv) * d:].reshape(b, s, hkv, d)
        q, k = ref.apply_rotary(q, k, cos, sin)
        ck = k.transpose(1, 2).to(torch.bfloat16).contiguous()[None]
        cv = v.transpose(1, 2).to(torch.bfloat16).contiguous()[None]
        attn = flash_prefill(q, ck, cv, 0, 0, s, window=cfg.sliding_window)
        x = x + apply_linear(lyr.wo, attn.to(x.dtype), layer_idx=i)
        h2 = ref.rms_norm_ref(x, lyr.post_norm[i], eps)
        gu = apply_linear(lyr.wgate_up, h2, layer_idx=i)
        f = gu.shape[-1] // 2
        act = (ref.silu_ref(gu[..., :f].float())
               * gu[..., f:].float()).to(x.dtype)
        yield {"qkv": rows(h), "wo": rows(attn), "gate_up": rows(h2),
               "down": rows(act)}
        x = x + apply_linear(lyr.down, act, layer_idx=i)
    yield {"lm_head": rows(ref.rms_norm_ref(x, params.final_norm, eps))}


def collect_calibration_inputs(params, cfg, ids):
    """The JAX package's return value: ``{"qkv": [L] of [N, E], "wo": [L]
    of [N, Hq*D], "gate_up": [L] of [N, E], "down": [L] of [N, F],
    "lm_head": [N, E]}`` as numpy f32 (every layer's activations at once;
    ``awq_scale_llama`` walks ``calibration_layers`` instead)."""
    acts = {k: [] for k in SITES}
    for rec in calibration_layers(params, cfg, ids):
        for k, a in rec.items():
            a = a.cpu().numpy()
            if k == "lm_head":
                acts[k] = a
            else:
                acts[k].append(a)
    return acts


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _rtn(w_kn: np.ndarray, group_size: int) -> np.ndarray:
    """Group-wise int4 round-trip of a [K, N] weight in numpy (numerics.py
    layout is [OC, IC] = [N, K], groups along IC=K — identical to
    conversion time); f32."""
    q, sc = quantize_groupwise_int4(w_kn.T.astype(np.float32), group_size)
    return dequantize_groupwise_int4(q, sc, group_size).T


def rtn_kn(w_kn: torch.Tensor, group_size: int) -> torch.Tensor:
    """``_rtn`` in torch on w's device: the f32 int4 round trip of a [K, N]
    weight, bit for bit."""
    q, sc = quantize_groupwise_int4_kn(w_kn, group_size)
    return dequantize_groupwise_int4_kn(q, sc, group_size)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _grid(s_base: np.ndarray, n_grid: int):
    """(alpha, s [K] f64) per grid point, as the JAX package computes them:
    s_base ** alpha in f32, normalised so the range is centred (llm-awq's
    trick keeps the folded weights in a healthy dynamic range) and clipped
    in f64."""
    for g in range(n_grid):
        alpha = g / n_grid
        s = s_base ** alpha  # f32: a Python float exponent keeps the dtype
        norm = np.sqrt(np.float64(float(s.max()) * float(s.min()) + 1e-20))
        s = np.clip(s.astype(np.float64) / norm, 1e-4, 1e4)
        yield alpha, s


def _losses_host(x: np.ndarray, w: np.ndarray, group_size: int, grid):
    """The grid's losses in numpy, the JAX package's operations and dtypes:
    y_ref = x @ w in f32, x @ wq in f64, the mean of squares in f64. Each
    grid point's loss is computed alone, so the threads change no bit."""
    y_ref = x @ w
    x64 = x.astype(np.float64)

    def loss(point):
        _, s = point
        ws = w.astype(np.float64) * s[:, None]
        wq = _rtn(ws, group_size).astype(np.float64) / s[:, None]
        return float(np.mean((x64 @ wq - y_ref.astype(np.float64)) ** 2))

    workers = max(1, min(HOST_THREADS, os.cpu_count() or 1,
                         HOST_BYTES // (32 * w.size)))
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(loss, grid))


def _losses_torch(x: torch.Tensor, w: torch.Tensor, group_size: int, grid,
                  chunk: int = LOSS_CHUNK):
    """The grid's losses in torch on x's device, the host's operations and
    dtypes: per slice of ``chunk`` weight columns, y_ref in f32 (TF32 off
    on the card), the scaled weight in f64 rounded to f32, ``rtn_kn``, the
    division by s and x @ wq in f64; the squared errors summed per slice in
    f64, the slices added in column order, divided by the count. Only the
    reduction order differs from numpy's mean."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the AWQ search's f32 products need TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32 = False)")
    n_cols = w.shape[1]
    x64 = x.double()
    y_ref = [x @ w[:, c:c + chunk] for c in range(0, n_cols, chunk)]
    losses = []
    for _, s in grid:
        s64 = torch.from_numpy(s).to(x.device)[:, None]
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        for j, c in enumerate(range(0, n_cols, chunk)):
            ws = (w[:, c:c + chunk].double() * s64).float()
            wq = rtn_kn(ws, group_size).double() / s64
            total += torch.sum((x64 @ wq - y_ref[j].double()) ** 2)
        losses.append(float(total) / (x.shape[0] * n_cols))
    return losses


def search_scale(x_rows, w_kn, group_size: int, n_grid: int = DEFAULT_GRID,
                 s_base: np.ndarray | None = None, device=None):
    """Grid-search alpha for one linear. x_rows [N, K] calibration inputs,
    w_kn [K, N] (numpy or tensors, read as f32). Returns (s [K] f64 numpy,
    best_alpha, losses).

    s_base defaults to per-channel mean |x| (the paper's activation
    salience), computed on the host; callers with channel-sharing
    constraints (GQA wo) pass a constrained s_base. alpha=0 (s=1) is in the
    grid, so AWQ can never do worse than plain RTN on the calibration
    objective. ``device`` (``None``: the card) runs the losses: numpy on
    the CPU, torch on the card (``_losses_torch``)."""
    dev = resolve_device(device)
    if s_base is None:
        s_base = np.mean(np.abs(_host(x_rows).astype(np.float32)), axis=0)
    s_base = np.maximum(np.asarray(s_base).astype(np.float32),
                        np.float32(1e-8))
    grid = list(_grid(s_base, n_grid))
    if dev.type == "cpu":
        losses = _losses_host(_host(x_rows).astype(np.float32),
                              _host(w_kn).astype(np.float32), group_size,
                              grid)
    else:
        def on_dev(a):
            return torch.as_tensor(a).to(dev, torch.float32)
        losses = _losses_torch(on_dev(x_rows), on_dev(w_kn), group_size, grid)
    best = (np.inf, 1.0, np.ones_like(s_base))
    for (alpha, s), loss in zip(grid, losses):
        if loss < best[0]:
            best = (loss, alpha, s)
    return best[2], best[1], losses


# ---------------------------------------------------------------------------
# folding
# ---------------------------------------------------------------------------

def awq_scale_llama(params, cfg, calib_ids, group_size: int = 128,
                    n_grid: int = DEFAULT_GRID):
    """fp LlamaParams -> (scaled fp LlamaParams, info dict), on the params'
    device.

    The returned tree computes the SAME function as ``params`` (scales are
    folded exactly; only the storage-dtype re-rounding of folded weights
    differs) but its weights are conditioned so that group-wise int4
    quantization (tools.convert.requantize_llama) loses less: quantize the
    RETURNED tree. ``calib_ids`` [B, S] int tokens drive the statistics.
    ``info["alpha"]`` holds each site's chosen alpha per layer (the
    lm_head's one float), ``info["losses"]`` each search's grid losses.

    The folds run as the JAX package's eager ops: the scale rounded from
    f64 to f32, then in f32 a true division for the norms and the folded
    columns and a product for the folded rows, then one bf16 rounding."""
    from tinychatengine_tpu_torch.models.llama import (LlamaLayerParams,
                                                       LlamaParams)

    if not isinstance(params.layers.wqkv, DenseLinear):
        raise ValueError("awq_scale_llama expects an fp (DenseLinear) tree")
    dev = params.embed.device
    lyr = params.layers
    n_layers = lyr.wqkv.weight.shape[0]
    d = cfg.head_dim
    ratio = cfg.num_heads // cfg.num_kv_heads
    info = {"alpha": {k: [] for k in SITES},
            "losses": {k: [] for k in SITES}}

    def s32(s):  # jnp.asarray of the f64 scale with x64 off: round to f32
        return torch.from_numpy(np.asarray(s).astype(np.float32)).to(dev)

    def fold_rows(w, s):  # w [K, N]; s [K]
        return (w.float() * s32(s)[:, None]).to(w.dtype)

    def fold_cols(w, s, lo, hi):  # divide w[:, lo:hi] columns by s
        wf = w.float()
        wf[:, lo:hi] = wf[:, lo:hi] / s32(s)[None, :]
        return wf.to(w.dtype)

    def divide(norm, s):
        return (norm.float() / s32(s)).to(norm.dtype)

    def search(site, x, w, s_base=None):
        s, a, losses = search_scale(x, w.float(), group_size, n_grid,
                                    s_base=s_base, device=dev)
        if site == "lm_head":
            info["alpha"][site], info["losses"][site] = a, losses
        else:
            info["alpha"][site].append(a)
            info["losses"][site].append(losses)
        return s

    in_norm, post_norm = [], []
    wqkv, wo, wgu, down = [], [], [], []
    layers = calibration_layers(params, cfg, calib_ids)
    for i, acts in zip(range(n_layers), layers):
        w_qkv, w_wo = lyr.wqkv.weight[i], lyr.wo.weight[i]
        w_gu, w_dn = lyr.wgate_up.weight[i], lyr.down.weight[i]
        hkv = w_qkv.shape[1] // (d * (ratio + 2))
        hq = ratio * hkv
        f = w_dn.shape[0]

        # qkv <- input_norm
        s_qkv = search("qkv", acts["qkv"], w_qkv)
        in_norm.append(divide(lyr.input_norm[i], s_qkv))
        w_qkv_s = fold_rows(w_qkv, s_qkv)

        # wo <- v columns (GQA: the ratio query heads reading one v head
        # must share its scale — constrain s_base by group-averaging)
        x_wo = acts["wo"]
        mag = np.mean(np.abs(_host(x_wo)), axis=0).reshape(hkv, ratio,
                                                            d).mean(1)
        s_wo = search("wo", x_wo, w_wo, s_base=np.repeat(
            mag[:, None, :], ratio, 1).reshape(-1))
        # s_wo is group-constant by construction of s_base (monotone map of
        # a group-constant vector stays group-constant)
        s_v = s_wo.reshape(hkv, ratio, d)[:, 0, :].reshape(-1)
        wqkv.append(fold_cols(w_qkv_s, s_v, (hq + hkv) * d,
                              (hq + 2 * hkv) * d))
        wo.append(fold_rows(w_wo, s_wo))

        # gate_up <- post_norm
        s_gu = search("gate_up", acts["gate_up"], w_gu)
        post_norm.append(divide(lyr.post_norm[i], s_gu))
        w_gu_s = fold_rows(w_gu, s_gu)

        # down <- up columns (silu(g) * u is linear in u)
        s_dn = search("down", acts["down"], w_dn)
        wgu.append(fold_cols(w_gu_s, s_dn, f, 2 * f))
        down.append(fold_rows(w_dn, s_dn))
        del acts

    # lm_head <- final_norm
    s_lm = search("lm_head", next(layers)["lm_head"], params.lm_head.weight)
    scaled = LlamaParams(
        embed=params.embed,
        layers=LlamaLayerParams(
            input_norm=torch.stack(in_norm),
            wqkv=DenseLinear(weight=torch.stack(wqkv), bias=lyr.wqkv.bias),
            wo=DenseLinear(weight=torch.stack(wo), bias=lyr.wo.bias),
            post_norm=torch.stack(post_norm),
            wgate_up=DenseLinear(weight=torch.stack(wgu),
                                 bias=lyr.wgate_up.bias),
            down=DenseLinear(weight=torch.stack(down), bias=lyr.down.bias)),
        final_norm=divide(params.final_norm, s_lm),
        lm_head=DenseLinear(weight=fold_rows(params.lm_head.weight, s_lm),
                            bias=params.lm_head.bias),
        rope_cos=params.rope_cos, rope_sin=params.rope_sin)
    return scaled, info
