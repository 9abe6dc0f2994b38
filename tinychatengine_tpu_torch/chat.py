"""Interactive chat CLI — the ``./chat`` of the reference
(llm/application/chat.cc) on the card (counterpart of the JAX package's
``chat.py``).

Usage:
    python -m tinychatengine_tpu_torch.chat --model llama3_8b \
        --checkpoint /path/to/converted/ckpt [--tokenizer /path/to/tokenizer]
    python -m tinychatengine_tpu_torch.chat --demo    # tiny random model

Differences from the reference CLI (argv ``./chat <model> <precision>
<threads>``, chat.cc:125-222): no thread-count argument; checkpoints are the
converted ``tinychatengine_tpu.v1`` format; a --demo mode runs a tiny
random-weight model with a byte tokenizer so the full REPL path is
exercisable without model downloads. The model runs on the card
(``--device cuda``, the default) or on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from tinychatengine_tpu_torch.core.config import (
    GenerationConfig,
    ModelConfig,
    QuantConfig,
    get_model_config,
)
from tinychatengine_tpu_torch.generation.chat_templates import template_for
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
from tinychatengine_tpu_torch.tokenizers.streaming import StreamDecoder

# ANSI colors (reference: llm/src/interface.cc)
_BOLD, _BLUE, _RESET = "\033[1m", "\033[34m", "\033[0m"

# per-family generation defaults (chat.cc:245-251,372-381,525-530,1051-1055)
FAMILY_GENCFG = {
    "llama3": dict(n_predict=512, temp=0.7, top_p=0.9, repeat_penalty=1.1),
    "llama2": dict(n_predict=512, temp=0.2),
    "mistral": dict(temp=0.3),
    "starcoder": dict(temp=0.2, top_k=0),
}


def _gen_config(model_name: str) -> GenerationConfig:
    g = GenerationConfig()
    for fam, overrides in FAMILY_GENCFG.items():
        if fam.replace("2", "") in model_name.lower() or fam in model_name.lower():
            for k, v in overrides.items():
                setattr(g, k, v)
            break
    return g


def build_demo_engine(device=None):
    # vocab padded to a lane multiple (384); pad ids masked out at sampling
    cfg = ModelConfig(
        name="demo", family="llama", num_heads=8, num_kv_heads=4, num_layers=4,
        max_sqlen=512, embed_dim=512, hidden_dim=1024, vocab_size=384,
        rms_norm_eps=1e-5)
    qcfg = QuantConfig(scheme="w4a16")
    params = llama.init_random_params(cfg, qcfg, seed=0, device=device)
    return Engine(params, cfg, qcfg, device=device), ByteTokenizer(), cfg


def build_engine(model: str, precision: str, checkpoint: str,
                 tokenizer_path: str | None, device=None):
    """A checkpoint's Engine, tokenizer and config (``precision`` is
    accepted and, as in the JAX package, the checkpoint's own quantization
    rules)."""
    from tinychatengine_tpu_torch.tools.checkpoint import (load_checkpoint,
                                                           load_tokenizer)
    cfg = get_model_config(model)
    params, qcfg = load_checkpoint(checkpoint, cfg, device=device)
    tok = load_tokenizer(tokenizer_path or checkpoint, cfg)
    return Engine(params, cfg, qcfg, device=device), tok, cfg


def shift_context(engine: Engine, history: list, n_keep: int):
    """llama.cpp-style context shift on window overflow: retain the first
    ``n_keep`` conversation tokens (system prompt) plus the most recent tail
    (half the window), re-prefill them into a fresh cache and continue —
    instead of dropping the whole conversation. The reference persists
    context up to max_sqlen and then stops growing (LLaMA3Generate.cc:74-75);
    llama.cpp's --keep shift is the behavior ``GenerationConfig.n_keep``
    advertises.

    Returns (cache, start, kept_history)."""
    n_keep = max(0, min(n_keep, engine.max_len // 4))
    tail = max(engine.max_len // 2 - n_keep, 1)
    kept = list(history[:n_keep]) + list(history[-tail:]) if history else []
    cache = engine.new_cache()
    if kept:
        _, cache = engine.prefill(np.asarray([kept], np.int32), cache)
    return cache, len(kept), kept


def repl(engine: Engine, tok, cfg: ModelConfig, gcfg: GenerationConfig,
         vlm_ctx=None, voice: bool = False, speculative: bool = False):
    """vlm_ctx: optional (clip_params, clip_cfg, image_path) — the image is
    encoded once and spliced into the first turn (LLaVAGenerate.cc:126).
    voice: STT input + sentence-buffered TTS output (the reference's ``-v``
    voicechat mode, chat.cc:264-273)."""
    tmpl = template_for(cfg.name)
    speaker = None
    if voice:
        from tinychatengine_tpu_torch.tools import speech
        speaker = speech.Speaker()
    stop_ids = [getattr(tok, "eos_id", -1)]
    for name in tmpl.stop_token_names:
        tid = getattr(tok, "special", {}).get(name) if hasattr(tok, "special") else None
        if tid is not None:
            stop_ids.append(tid)

    cache = engine.new_cache()
    start = 0
    first = True
    history: list[int] = []   # full conversation ids (for context shifting)
    used_embeds = False       # image embeds can't be re-prefilled from ids
    print(f"{_BOLD}TinyChatEngine-TPU{_RESET} — model {cfg.name} "
          f"(ctx {engine.max_len}). Ctrl-D to exit.")
    while True:
        try:
            if voice:
                from tinychatengine_tpu_torch.tools import speech
                print(f"{_BOLD}USER (speak): {_RESET}", end="", flush=True)
                user = speech.listen()
                print(user)
            else:
                user = input(f"{_BOLD}USER: {_RESET}")
        except EOFError:
            print()
            return
        if not user.strip():
            continue
        wrap = tmpl.first if first else tmpl.next
        input_embeds = None
        if vlm_ctx is not None and first and "{image}" in wrap:
            from tinychatengine_tpu_torch.generation import vlm
            clip_params, clip_cfg, image_path = vlm_ctx
            image_embeds = vlm.encode_image(clip_params, clip_cfg,
                                            vlm.load_image(image_path))
            prompt = wrap.replace("{image}", vlm.IMAGE_MARKER).format(input=user)
            ids_arr, input_embeds = vlm.build_multimodal_inputs(
                tok, engine.params.embed, prompt, image_embeds,
                bos=(start == 0))
            ids = ids_arr[0].tolist()
        else:
            prompt = wrap.replace("{image}", "").format(input=user)
            ids = tok.encode(prompt, bos=(start == 0))
        first = False

        print(f"{_BOLD}ASSISTANT: {_RESET}", end="", flush=True)
        text_buf = []
        sdec = StreamDecoder(tok)

        def on_token(t):
            piece = sdec.feed(t)  # UTF-8-safe incremental detokenization
            text_buf.append(piece)
            sys.stdout.write(_BLUE + piece + _RESET)
            sys.stdout.flush()
            if speaker is not None:
                speaker.feed(piece)
            # stop-string check (reference: break on "### Human" etc.)
            tail = "".join(text_buf[-8:])
            return not any(s_ in tail for s_ in tmpl.stop_strings)

        result = None
        if speculative and input_embeds is None:
            from tinychatengine_tpu_torch.generation.speculative import (
                generate_pld)
            toks, n_steps, cache = generate_pld(
                engine, np.asarray([ids], np.int32),
                n_tokens=max(1, min(gcfg.n_predict,
                                    engine.max_len - start - len(ids) - 16)),
                cache=cache, start=start)
            out_toks = []
            for t in toks.tolist():  # host-side stop handling
                out_toks.append(t)
                if t in stop_ids:
                    break
                if on_token(t) is False:
                    break
            n_gen = len(out_toks)
            print(f" [{n_gen} tokens in {n_steps} forwards]",
                  end="", file=sys.stderr)
        else:
            result = engine.generate(
                np.asarray([ids], np.int32), gcfg, stop_token_ids=stop_ids,
                on_token=on_token, cache=cache, start=start,
                input_embeds=input_embeds)
            cache = result.cache
            n_gen = len(result.tokens[0])
        if speaker is not None:
            speaker.flush()
        print()
        # context persists across turns (reference keeps past_kv static;
        # LLaMA3Generate.cc:74-75) — continue from the updated position
        start += len(ids) + n_gen
        used_embeds = used_embeds or input_embeds is not None
        history.extend(ids)
        out_ids = (result.tokens[0] if result is not None else out_toks)
        history.extend(int(t) for t in out_ids)
        if start >= engine.max_len - 8:
            if used_embeds:
                # image tokens live only as embeds — can't re-prefill from ids
                print("[context full — resetting]")
                cache = engine.new_cache()
                start = 0
                first = True
                history = []
                used_embeds = False
            else:
                print("[context full — shifting (n_keep="
                      f"{gcfg.n_keep})]")
                cache, start, history = shift_context(engine, history,
                                                      gcfg.n_keep)
        if result is not None:
            print(turn_line(n_gen, result.decode_s, result.ttft_s),
                  file=sys.stderr)


def turn_line(n_tokens: int, decode_s: float, ttft_s: float) -> str:
    """The per-turn latency line (``llm/include/profiler.h``'s demo-mode
    summary) from a ``GenerationResult``'s decode seconds and TTFT."""
    if decode_s == 0 or n_tokens == 0:
        return "Inference latency: n/a"
    ms_per_tok = decode_s * 1e3 / n_tokens
    return (f"Inference latency: total {decode_s:.2f}s, "
            f"{ms_per_tok:.1f} ms/token, {1e3 / ms_per_tok:.1f} token/s, "
            f"{n_tokens} tokens, TTFT {ttft_s * 1e3:.0f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser(description="TinyChatEngine chat "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--model", default="llama3_8b")
    ap.add_argument("--precision", default="INT4",
                    choices=["FP32", "FP", "INT4", "INT8"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--demo", action="store_true",
                    help="tiny random-weight model + byte tokenizer")
    ap.add_argument("--n-predict", type=int, default=None)
    ap.add_argument("--temp", type=float, default=None)
    ap.add_argument("--image", default=None,
                    help="image file for VLM (LLaVA/VILA) models — spliced "
                         "into the first turn (llm/scripts/vila.sh semantics)")
    ap.add_argument("-v", "--voice", action="store_true",
                    help="voice chat: STT input, sentence-buffered TTS output "
                         "(needs whisper.cpp stream / piper on PATH)")
    ap.add_argument("--speculative", action="store_true",
                    help="prompt-lookup speculative decoding (greedy only: "
                         "forces temp 0, no penalties)")
    ap.add_argument("--device", default="cuda",
                    help="the model's device: cuda (the card) or cpu")
    args = ap.parse_args(argv)

    vlm_ctx = None
    if args.demo:
        engine, tok, cfg = build_demo_engine(device=args.device)
        if args.image:
            # llava chat template (image splice) for the demo VLM
            cfg = dataclasses.replace(cfg, name="demo_llava")
            engine.cfg = cfg
            from tinychatengine_tpu_torch.models import clip as clip_mod
            clip_cfg = ModelConfig(
                name="demo_clip", family="clip", num_heads=4, num_kv_heads=4,
                num_layers=2, max_sqlen=0, embed_dim=256, hidden_dim=512,
                vocab_size=0, image_size=56, patch_size=14,
                mmproj_dim=cfg.embed_dim)
            vlm_ctx = (clip_mod.init_random_params(clip_cfg,
                                                   device=args.device),
                       clip_cfg, args.image)
    else:
        if not args.checkpoint:
            ap.error("--checkpoint required (or use --demo)")
        engine, tok, cfg = build_engine(args.model, args.precision,
                                        args.checkpoint, args.tokenizer,
                                        device=args.device)
        if args.image:
            from tinychatengine_tpu_torch.tools.checkpoint import load_clip
            clip_params, clip_cfg = load_clip(args.checkpoint,
                                              device=args.device)
            vlm_ctx = (clip_params, clip_cfg, args.image)

    gcfg = _gen_config(cfg.name)
    if args.demo:  # mask vocab-padding ids beyond the byte tokenizer's range
        gcfg.logit_bias = {i: -1e9 for i in range(tok.vocab_size, cfg.vocab_size)}
    if args.n_predict is not None:
        gcfg.n_predict = args.n_predict
    if args.temp is not None:
        gcfg.temp = args.temp
    if args.speculative:
        gcfg.temp = 0.0
        gcfg.repeat_penalty = 1.0
        gcfg.frequency_penalty = gcfg.presence_penalty = 0.0
    repl(engine, tok, cfg, gcfg, vlm_ctx=vlm_ctx, voice=args.voice,
         speculative=args.speculative)


if __name__ == "__main__":
    main()
