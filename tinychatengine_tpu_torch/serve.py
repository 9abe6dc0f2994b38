"""Serve a model over the OpenAI-compatible REST API (counterpart of the JAX
package's ``serve.py``).

Usage:
    python -m tinychatengine_tpu_torch.serve --demo --port 8000
    python -m tinychatengine_tpu_torch.serve --model llama3_8b \
        --checkpoint ckpt_dir --port 8000 --slots 8 --paged

The reference ships only a terminal REPL (llm/application/chat.cc); this is
the network-serving surface above the continuous-batching ServingEngine
(runtime/serving.py) + HTTP front-end (runtime/server.py). The model runs
on the card (``--device cuda``, the default) or, for a rehearsal, on the
CPU (``--device cpu``). The JAX package's ``--compilation-cache`` (XLA's
persistent cache) has no counterpart: the port's kernels are cached by
``ops/_build.py`` under ``build/tce_torch/``.

Try it:
    curl localhost:8000/v1/chat/completions -d '{
      "messages": [{"role": "user", "content": "hi"}], "max_tokens": 16}'
"""

from __future__ import annotations

import argparse
import time

from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig,
                                                  get_model_config)
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.runtime.server import InferenceServer
from tinychatengine_tpu_torch.runtime.serving import ServingEngine


def build_demo_clip(embed_dim: int, device=None):
    """Tiny random CLIP encoder for --demo --vision (mirrors chat.py's
    --demo --image wiring)."""
    from tinychatengine_tpu_torch.models import clip
    ccfg = ModelConfig(
        name="clip_demo", family="clip", num_heads=4, num_kv_heads=4,
        num_layers=2, max_sqlen=0, embed_dim=64, hidden_dim=128,
        vocab_size=0, image_size=56, patch_size=14, mmproj_dim=embed_dim)
    return clip.init_random_params(ccfg, device=device), ccfg


def build_demo_serving(slots: int = 4, device=None, **kw):
    """Tiny random-weight model + byte tokenizer: full serving path, no
    checkpoint (mirrors chat.py --demo)."""
    cfg = ModelConfig(
        name="demo", family="llama", num_heads=8, num_kv_heads=4, num_layers=4,
        max_sqlen=512, embed_dim=512, hidden_dim=1024, vocab_size=384,
        rms_norm_eps=1e-5)
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    qcfg = QuantConfig(scheme="w4a16")
    params = llama.init_random_params(cfg, qcfg, seed=0, device=device)
    tok = ByteTokenizer()
    # NOTE: vocab-padding ids (258-383) are NOT masked here — a logit_bias
    # of 126 entries would exceed RowParams.MAX_BIAS and force the
    # engine-global sampler, rejecting per-request sampling params. Padding
    # ids decode to "" (byte_fallback.decode drops ids >= 256), so they are
    # cosmetic only in a random-weight demo.
    gcfg = GenerationConfig(n_ctx=512)
    engine = ServingEngine(params, cfg, qcfg, slots=slots, gcfg=gcfg,
                           device=device, **kw)
    return engine, tok


def build_serving(model: str, precision: str, checkpoint: str,
                  tokenizer_path: str | None, slots: int, device=None, **kw):
    """A checkpoint's ServingEngine and tokenizer (``precision`` is accepted
    and, as in the JAX package, the checkpoint's own quantization rules)."""
    from tinychatengine_tpu_torch.tools.checkpoint import (load_checkpoint,
                                                           load_tokenizer)
    cfg = get_model_config(model)
    params, qcfg = load_checkpoint(checkpoint, cfg, device=device)
    tok = load_tokenizer(tokenizer_path or checkpoint, cfg)
    engine = ServingEngine(params, cfg, qcfg, slots=slots, device=device,
                           **kw)
    return engine, tok


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="TinyChatEngine OpenAI-compatible server (PyTorch/CUDA)")
    ap.add_argument("--model", default="llama3_8b")
    ap.add_argument("--precision", default="INT4",
                    choices=["INT4", "INT8", "FP32", "BF16"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--demo", action="store_true",
                    help="tiny random model + byte tokenizer (no checkpoint)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=8,
                    help="continuous-batching slots")
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (page pool instead of slot-reserved)")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                    help="KV prefix-cache entries (0 = off)")
    ap.add_argument("--speculative", action="store_true",
                    help="prompt-lookup speculative decoding in tick bursts")
    ap.add_argument("--tick-batch", type=int, default=16, metavar="K",
                    help="decode ticks run back to back between host "
                    "fetches when the queue is idle (throughput knob; "
                    "streamed tokens arrive in bursts of up to K; 1 = "
                    "latency-first)")
    ap.add_argument("--vision", action="store_true",
                    help="enable image_url chat content parts (VLM): loads "
                    "the checkpoint's CLIP encoder (or a tiny random one "
                    "with --demo) and splices image embeddings into prompts")
    ap.add_argument("--device", default="cuda",
                    help="the model's device: cuda (the card) or cpu")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    kw = dict(paged=args.paged, max_len=args.max_len,
              speculative=args.speculative, tick_batch=args.tick_batch,
              prefix_cache_entries=args.prefix_cache, device=args.device)
    clip_params = clip_cfg = None
    if args.demo:
        engine, tok = build_demo_serving(slots=args.slots, **kw)
        if args.vision:
            clip_params, clip_cfg = build_demo_clip(engine.cfg.embed_dim,
                                                    device=args.device)
    else:
        if not args.checkpoint:
            ap.error("--checkpoint required (or use --demo)")
        engine, tok = build_serving(args.model, args.precision,
                                    args.checkpoint, args.tokenizer,
                                    args.slots, **kw)
        if args.vision:
            from tinychatengine_tpu_torch.tools.checkpoint import load_clip
            clip_params, clip_cfg = load_clip(args.checkpoint,
                                              device=args.device)

    server = InferenceServer(engine, tok, clip_params=clip_params,
                             clip_cfg=clip_cfg)
    port = server.start(host=args.host, port=args.port)
    print(f"serving {server.model_name} on http://{args.host}:{port} "
          f"({args.slots} slots{', paged' if args.paged else ''})",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("\nshutting down")
        server.close()


if __name__ == "__main__":
    main()
