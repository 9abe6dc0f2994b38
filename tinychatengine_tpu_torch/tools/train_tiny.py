"""Train the in-repo accuracy models (``bytellama_5m``, ``byteopt_4m``) on
local Python source (counterpart of the JAX package's
``tools/train_tiny.py``).

Nothing is downloaded: a byte-level model is trained on the local source
corpus (``tools/corpus.py``), saved in the framework's checkpoint format
and scored fp against its quantized schemes with ``tools/perplexity.py``,
giving the Delta-ppl table of ``ACCURACY.md``.

The arithmetic is the JAX package's:
  - f32 master tensors and AdamW moments, bf16 compute: each step casts
    the masters to bf16 inside the loss (differentiable casts), the RoPE
    tables stay f32 and are not trained;
  - optax's chain ``clip_by_global_norm(1.0)`` then
    ``adamw(warmup_cosine_decay, b1=0.9, b2=0.95, weight_decay=0.05)``,
    written out on ``torch.optim.AdamW``: decay on every trained tensor,
    norms and embeddings included, and the schedule evaluated at count 0
    for the first update (``lr_schedule``, ``clip_by_global_norm``);
  - the corpus lives on the device as uint8; each step draws its batch
    offsets there (``draw_offsets``) and gathers the windows on the
    device, so a step reads nothing back to the host; the losses are
    read once every ``scan_chunk`` steps, when they are logged;
  - attention trains through the plain version, which the forwards take
    while autograd records (``models.llama.records``: the kernels have no
    backward; the JAX package trains through ``attention_xla``).

    python -m tinychatengine_tpu_torch.tools.train_tiny \\
        --out assets/bytellama_5m [--steps 3000] [--batch 16] [--window 512]
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import dataclasses
import functools
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import kv_cache as kvc

BOS = 256  # the byte tokenizer's BOS id

_f32 = np.float32


@functools.cache
def _cosf():
    """The C library's f32 cosine, which XLA's CPU backend calls (an f64
    cosine rounded once to f32 parts from it by up to 3 ulps of the
    schedule over 3000 steps)."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def _fma(a, b, c) -> np.float32:
    """f32 fused multiply-add: the f64 product of two f32 values is exact,
    so one rounding of the f64 sum."""
    return _f32(float(a) * float(b) + float(c))


def lr_schedule(step: int, steps: int, peak_lr: float) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak_lr, warmup_steps=
    min(100, steps // 10), decay_steps=steps, end_value=peak_lr * 0.01)``
    at count ``step``, in f32 as jitted XLA on the CPU evaluates it: the
    divisions by constants as products by folded reciprocals, the two
    multiply-adds fused, and the C library's ``cosf``."""
    warmup = min(100, steps // 10)
    if step < warmup:  # linear_schedule(0, peak, warmup)
        frac = _fma(-_f32(min(max(step, 0), warmup)),
                    _f32(1) / _f32(warmup), _f32(1))
        return float(_fma(frac, _f32(0.0 - peak_lr), _f32(peak_lr)))
    decay = steps - warmup  # cosine_decay_schedule(peak, decay, alpha)
    alpha = (peak_lr * 0.01) / peak_lr
    x = _f32(min(step - warmup, decay)) * (_f32(math.pi)
                                          * (_f32(1) / _f32(decay)))
    cos1 = _f32(_cosf()(float(x))) + _f32(1)
    decayed = _fma(cos1, _f32(0.5) * _f32(1 - alpha), _f32(alpha))
    return float(decayed * _f32(peak_lr))


def clip_by_global_norm(grads: list, max_norm: float = 1.0) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place, on the device: with g_norm
    the square root of the sum of every tensor's sum of squares, each
    gradient becomes ``(g / g_norm) * max_norm`` unless
    ``g_norm < max_norm``. Returns g_norm (not read on the host)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))
    return g_norm


def draw_offsets(gen: torch.Generator, batch: int, n: int,
                 window: int) -> torch.Tensor:
    """One step's ``batch`` window offsets in [0, n - window - 1), drawn
    on the generator's device."""
    return torch.randint(0, n - window - 1, (batch,), generator=gen,
                         device=gen.device)


def _hooks(family: str):
    """Per-family training hooks: (init, forward, protected field names).
    ``init(cfg, qcfg, seed, device)`` gives the fp tree; ``protected``
    fields are constants (the llama RoPE tables), kept f32 and not
    trained."""
    if family == "opt":
        from tinychatengine_tpu_torch.models import opt

        def init(cfg, qcfg, seed, device):
            return opt.init_random_params(cfg, quantized=False, seed=seed,
                                          device=device)
        return init, opt.forward, ()
    from tinychatengine_tpu_torch.models import llama

    def init(cfg, qcfg, seed, device):
        return llama.init_random_params(cfg, qcfg, seed=seed, device=device)
    return init, llama.forward, ("rope_cos", "rope_sin")


def _tree_map(p, fn, path: str = ""):
    """``fn(path, tensor)`` over every tensor leaf of a parameter
    dataclass tree (path: field names joined by ``/``)."""
    if p is None:
        return None
    if isinstance(p, torch.Tensor):
        return fn(path, p)
    return type(p)(**{f.name: _tree_map(getattr(p, f.name), fn,
                                        f"{path}/{f.name}" if path
                                        else f.name)
                      for f in dataclasses.fields(p)})


def _trained(path: str, protected) -> bool:
    return path.split("/")[0] not in protected


def _cast_bf16(params, protected=("rope_cos", "rope_sin")):
    """f32 masters -> the bf16 compute view (differentiable casts); the
    protected constants stay as they are."""
    return _tree_map(params, lambda k, t: t.to(torch.bfloat16)
                     if _trained(k, protected) and t.dtype == torch.float32
                     else t)


def batch_loss(forward_fn, params, cfg, ids: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL (f32 log-softmax) of BOS-led windows ids
    [B, W + 1]: the forward runs ids[:, :-1] into a fresh bf16 cache of
    W + 1 positions at start 0 with ``full_logits``."""
    b, w1 = ids.shape
    cache = kvc.init_cache(cfg.num_layers, b, w1, cfg.num_kv_heads,
                           cfg.head_dim, device=ids.device)
    logits, _ = forward_fn(params, cfg, ids[:, :-1], cache, 0,
                           full_logits=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, ids[:, 1:, None])[..., 0].mean()


def train(cfg, corpus_train: bytes, steps: int = 3000, batch: int = 16,
          window: int = 512, peak_lr: float = 3e-3, seed: int = 0,
          scan_chunk: int = 250, log=print, device=None, history=None):
    """Returns the trained params as the standard bf16 inference tree on
    ``device`` (the card by default). ``history``: a list that receives
    every step's loss (read from the device once every ``scan_chunk``
    steps)."""
    from tinychatengine_tpu_torch.core.config import QuantConfig

    dev = resolve_device(device)
    init_params, forward_fn, protected = _hooks(cfg.family)
    params = init_params(cfg, QuantConfig(scheme="fp"), seed, dev)
    # f32 masters (bf16 masters lose ~8 mantissa bits of update signal)
    leaves = []

    def master(path, t):
        if not _trained(path, protected):
            return t
        m = t.detach().float().clone().requires_grad_()
        leaves.append(m)
        return m
    params = _tree_map(params, master)
    opt = torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.05)

    data = torch.frombuffer(bytearray(corpus_train), dtype=torch.uint8).to(dev)
    n = int(data.shape[0])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    bos = torch.full((batch, 1), BOS, dtype=torch.long, device=dev)
    cols = torch.arange(window, device=dev)[None, :]
    chunk = []
    t0 = time.time()
    for step in range(steps):
        offs = draw_offsets(gen, batch, n, window)
        ids = torch.cat([bos, data[offs[:, None] + cols].long()], dim=1)
        loss = batch_loss(forward_fn, _cast_bf16(params, protected), cfg, ids)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm([m.grad for m in leaves], 1.0)
        for group in opt.param_groups:
            group["lr"] = lr_schedule(step, steps, peak_lr)
        opt.step()
        chunk.append(loss.detach())
        done = step + 1
        if len(chunk) == scan_chunk or done == steps:
            losses = torch.stack(chunk).cpu().numpy()  # waits for the device
            chunk = []
            if history is not None:
                history.extend(float(v) for v in losses)
            tok_s = done * batch * window / max(time.time() - t0, 1e-9)
            log(f"  step {done}/{steps}  loss {losses[-16:].mean():.4f}  "
                f"({tok_s / 1e3:.0f}k tok/s)")
    with torch.no_grad():
        return _cast_bf16(params, protected)


def corpus_split(corpus_mb: int) -> tuple[bytes, bytes]:
    """The local-source corpus capped at ``corpus_mb`` MB, split into
    (train, held-out eval): the last 1 MB held out, as in the JAX package,
    which refuses corpora under 2 MB; a smaller corpus holds out its last
    quarter."""
    from tinychatengine_tpu_torch.tools import corpus as corpus_mod

    corpus = corpus_mod.build_corpus(max_bytes=corpus_mb << 20)
    return corpus_mod.train_eval_split(corpus,
                                       min(1 << 20, len(corpus) // 4))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="assets/bytellama_5m")
    ap.add_argument("--model", default="bytellama_5m",
                    help="bytellama_5m (llama Delta-ppl pyramid) or "
                         "byteopt_4m (the SmoothQuant W8A8 row)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--corpus-mb", type=int, default=48)
    ap.add_argument("--eval-tokens", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where training and scoring run: cuda (the card) "
                         "or cpu")
    return ap


def score(params, cfg, train_b: bytes, ids, log=print) -> list:
    """(label, ppl) rows of the trained fp tree on eval ids (512-token
    windows, stride 256): llama at fp, w4a16, w4a8 and w4a16 with the
    int8 KV cache (``requantize_llama``); OPT at fp and W8A8 with
    SmoothQuant alpha 0.5 and 0, calibrated on the train split."""
    from tinychatengine_tpu_torch.core.config import QuantConfig
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import \
        ByteTokenizer
    from tinychatengine_tpu_torch.tools.perplexity import perplexity

    rows = []
    if cfg.family == "opt":
        from tinychatengine_tpu_torch.models import opt
        from tinychatengine_tpu_torch.tools.calibrate_opt import \
            quantize_opt_w8a8

        dev = params.embed_tokens.device
        # calibration sample from the TRAIN split (never the eval text)
        calib = np.asarray(ByteTokenizer().encode(
            train_b[: 64 << 10].decode("utf-8", errors="ignore")),
            np.int32)[:512][None, :]
        schemes = [("fp (bf16)", lambda: params),
                   ("w8a8 (SmoothQuant a=0.5)",
                    lambda: quantize_opt_w8a8(params, cfg, calib, 0.5,
                                              device=dev)),
                   ("w8a8 (no smoothing)",
                    lambda: quantize_opt_w8a8(params, cfg, calib, 0.0,
                                              device=dev))]
        for label, mk in schemes:
            t0 = time.time()
            ppl = perplexity(opt.forward, mk(), cfg, ids, window=512,
                             stride=256)
            rows.append((label, ppl))
            log(f"  {label:26s} ppl {ppl:.4f}   ({time.time() - t0:.0f}s)")
        return rows
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.tools.convert import requantize_llama
    for label, qcfg, qkv in [
            ("fp (bf16)", QuantConfig(scheme="fp"), False),
            ("w4a16", QuantConfig(scheme="w4a16", group_size=128), False),
            ("w4a8", QuantConfig(scheme="w4a8", group_size=128), False),
            ("w4a16 + int8 KV", QuantConfig(scheme="w4a16", group_size=128,
                                            kv_cache_dtype="int8"), True)]:
        t0 = time.time()
        ppl = perplexity(llama.forward, requantize_llama(params, qcfg), cfg,
                         ids, window=512, stride=256, quantized_kv=qkv)
        rows.append((label, ppl))
        log(f"  {label:18s} ppl {ppl:.4f}   ({time.time() - t0:.0f}s)")
    return rows


def main(argv=None) -> dict:
    """The CLI; returns what it measured: every step's loss, the training
    seconds and tokens per second, the unrounded (label, ppl) rows and
    the ppl report (both None with ``--skip-eval``)."""
    from tinychatengine_tpu_torch.core.config import (QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import \
        ByteTokenizer
    from tinychatengine_tpu_torch.tools.checkpoint import save_checkpoint

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_model_config(args.model)
    print("building corpus...")
    train_b, eval_b = corpus_split(args.corpus_mb)
    print(f"  train {len(train_b) / 1e6:.1f} MB, eval "
          f"{len(eval_b) / 1e6:.1f} MB")

    history = []
    t0 = time.time()
    params = train(cfg, train_b, steps=args.steps, batch=args.batch,
                   window=args.window, seed=args.seed, device=dev,
                   history=history)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.time() - t0
    out = {"losses": history, "train_s": train_s,
           "train_tok_s": args.steps * args.batch * args.window / train_s,
           "rows": None, "report": None}

    path = Path(args.out)
    save_checkpoint(str(path), params, cfg, QuantConfig(scheme="fp"),
                    extra_meta={"family": cfg.family,
                                "trained_on": "local python source "
                                f"({len(train_b)} bytes)",
                                "steps": args.steps})
    # the eval sample: the first 128 KB of the held-out split, so a
    # regression test scores the exact text the table was measured on
    sample = eval_b[:128 << 10].decode("utf-8", errors="ignore")
    (path / "eval_sample.txt").write_text(sample, encoding="utf-8")
    print(f"saved {path}")
    if args.skip_eval:
        return out

    ids = np.asarray(ByteTokenizer().encode(
        eval_b.decode("utf-8", errors="ignore")), np.int32)[:args.eval_tokens]
    rows = score(params, cfg, train_b, ids)
    fp_ppl = rows[0][1]
    report = {"model": cfg.name, "eval_tokens": int(len(ids)),
              "window": 512, "stride": 256,
              "rows": [{"scheme": label, "ppl": round(p, 4),
                        "delta_vs_fp": round(p - fp_ppl, 4)}
                       for label, p in rows]}
    (path / "ppl.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    out.update(rows=rows, report=report)
    return out


if __name__ == "__main__":
    main()
