#!/usr/bin/env python3
"""Decode benchmark of the PyTorch/CUDA port on one NVIDIA GPU:
llama3_8b W4A8 (random packed weights from seed 0 at full width, max_len
2048) through ``Engine.generate_device`` on its captured CUDA graphs.

Prints ONE JSON line shaped like ``bench.py``'s: {"metric", "value",
"unit", "vs_baseline", "ttft_ms_p50", "prefill_tokens_per_s",
"stream_gbps_measured", "vs_stream_roofline"}.

- value: decode tokens/s, t(prompt + 1 + N tokens) - t(prompt + 1 token)
  over N = 256, each the median of its own 4 trials, fresh prompts per
  trial (bench.py's method); greedy with repeat_penalty 1.1 over the last
  64 tokens, 64-token prompts.
- ttft_ms_p50: the median 1-token run (prefill of the 64-token prompt, one
  decode step, the sample, the fetch).
- prefill_tokens_per_s: (2047 - 64) / (t(2047-token prompt) - t(64))
  (2047 tokens fill the 2048 bucket and leave the cache the one decode
  position the run takes).
- vs_baseline: value over the HBM roofline at the data sheet's 3.35 TB/s
  for the bytes a token must read: every layer's packed weights and
  scales, the lm_head's, and the mean KV cache of the run.
- stream_gbps_measured / vs_stream_roofline: the same against the card's
  measured copy rate (a 2 GiB device-to-device copy, read + write bytes
  over CUDA-event time).

The card's name and power limit go to stderr. Run from the root of a
checkout: ``python3 scripts/bench_torch.py``. Exits 2 without a card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3, the data sheet's rate
METRIC = "llama3_8b_w4a8_decode_tokens_per_s_per_chip"


def stream_bytes_per_s(n_bytes: int = 2 << 30, iters: int = 20) -> float:
    """The card's copy rate: bytes read plus written by ``dst.copy_(src)``
    over ``n_bytes`` of int32, per CUDA-event second."""
    src = torch.randint(0, 1 << 30, (n_bytes // 4,), dtype=torch.int32,
                        device="cuda")
    dst = torch.empty_like(src)
    for _ in range(3):
        dst.copy_(src)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        dst.copy_(src)
    t1.record()
    torch.cuda.synchronize()
    sec = t0.elapsed_time(t1) / 1e3 / iters
    del src, dst
    torch.cuda.empty_cache()
    return 2 * n_bytes / sec


def tensor_bytes(tree) -> int:
    """Bytes of every tensor leaf of a parameter dataclass tree."""
    from tinychatengine_tpu_torch.tools.checkpoint import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"metric": METRIC, "value": None,
                          "unit": "tokens/s", "vs_baseline": None,
                          "error": "no CUDA device"}))
        return 2
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import llama

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(f"device: {torch.cuda.get_device_name(0)}; "
          f"{smi[0] if smi else 'nvidia-smi: no reading'}", file=sys.stderr)

    cfg = get_model_config("llama3_8b")
    qcfg = QuantConfig(scheme="w4a8", group_size=128)
    max_len, prompt_len, n_decode, prefill_len = 2048, 64, 256, 2047
    params = llama.init_random_params(cfg, qcfg, seed=0, max_pos=max_len,
                                      fast=True, device="cuda")
    eng = Engine(params, cfg, qcfg, batch=1, max_len=max_len, device="cuda")
    g = GenerationConfig(temp=0.0, n_predict=128, repeat_penalty=1.1,
                         repeat_last_n=64)

    def run(seed, n_tokens, plen=prompt_len):
        ids = np.random.default_rng(seed).integers(
            100, cfg.vocab_size - 100, (1, plen))
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.generate_device(ids, g, n_tokens=n_tokens).cpu()
        return time.perf_counter() - t

    # the captures: the two prompt buckets and the decode step
    run(0, 1)
    run(0, 1 + n_decode)
    run(0, 1, plen=prefill_len)
    shorts, longs, pfs = [], [], []
    for trial in range(4):
        shorts.append(run(10 + trial, 1))
        longs.append(run(20 + trial, 1 + n_decode))
        pfs.append(run(30 + trial, 1, plen=prefill_len))
        print(f"trial {trial}: short={shorts[-1]:.4f}s long={longs[-1]:.4f}s "
              f"prefill={pfs[-1]:.4f}s", file=sys.stderr)
    short, long_, pf = (float(np.median(x)) for x in (shorts, longs, pfs))
    tokens_per_s = n_decode / (long_ - short)
    prefill_tok_s = (prefill_len - prompt_len) / max(pf - short, 1e-9)

    avg_ctx = prompt_len + n_decode // 2
    kv_bytes = (cfg.num_layers * avg_ctx * cfg.num_kv_heads * cfg.head_dim
                * 2 * 2)
    bytes_per_token = (tensor_bytes(params.layers)
                       + tensor_bytes(params.lm_head) + kv_bytes)
    roofline = HBM_BYTES_S / bytes_per_token
    del eng, params
    torch.cuda.empty_cache()
    stream = stream_bytes_per_s()
    print(f"{bytes_per_token / 1e9:.3f} GB a token; HBM roofline "
          f"{roofline:.1f} tok/s; measured copy {stream / 1e9:.0f} GB/s -> "
          f"{stream / bytes_per_token:.1f} tok/s", file=sys.stderr)
    print(json.dumps({
        "metric": METRIC,
        "value": round(tokens_per_s, 2),
        "unit": "tokens/s",
        "vs_baseline": round(tokens_per_s / roofline, 3),
        "ttft_ms_p50": round(short * 1e3, 2),
        "prefill_tokens_per_s": round(prefill_tok_s, 0),
        "stream_gbps_measured": round(stream / 1e9, 0),
        "vs_stream_roofline": round(tokens_per_s
                                    / (stream / bytes_per_token), 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
