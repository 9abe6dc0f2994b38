"""Sliding-window perplexity, the quantization-accuracy harness
(counterpart of the JAX package's ``tools/perplexity.py``).

Windows of ``window`` tokens advance by ``stride``; only the last
``stride`` positions of each window (every position of the first) add
their log-likelihood. Runs on the device the params lie on, with any
family's forward (``llama.forward``, ``opt.forward``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tinychatengine_tpu_torch.generation import kv_cache as kvc


@torch.inference_mode()
def perplexity(forward_fn, params, cfg, token_ids, window: int = 1024,
               stride: int = 512, progress=None,
               quantized_kv: bool = False) -> float:
    """token_ids: 1-D ints. Returns exp(mean nll). quantized_kv=True scores
    through an int8 KV cache."""
    ids = np.asarray(token_ids, np.int64)
    n = len(ids)
    assert n >= 2, "need at least two tokens"
    window = min(window, cfg.max_sqlen, n)
    stride = min(stride, window)
    # the device of the token embedding: llama's ``embed``, opt's
    # ``embed_tokens``
    dev = getattr(params, "embed", None)
    dev = (params.embed_tokens if dev is None else dev).device

    total_nll, total_cnt = 0.0, 0
    start = 0
    while start + 1 < n:
        end = min(start + window, n)
        chunk = np.zeros((1, window), np.int64)
        chunk[0, :end - start] = ids[start:end]
        n_ctx = 1 if start == 0 else window - stride
        cache = kvc.init_cache(cfg.num_layers, 1, window, cfg.num_kv_heads,
                               cfg.head_dim, quantized=quantized_kv,
                               device=dev)
        chunk_t = torch.as_tensor(chunk, device=dev)
        logits, _ = forward_fn(params, cfg, chunk_t, cache, 0,
                               full_logits=True)
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = torch.gather(logp[0, :-1], -1, chunk_t[0, 1:, None])[:, 0]
        tgt = torch.arange(1, window, device=dev)  # target positions
        mask = (tgt >= n_ctx) & (tgt < end - start)
        total_nll += float(torch.where(mask, -tok_lp, 0.0).sum())
        total_cnt += int(mask.sum())
        if progress:
            progress(end, n, math.exp(total_nll / max(total_cnt, 1)))
        if end == n:
            break
        start += stride
    return math.exp(total_nll / max(total_cnt, 1))
