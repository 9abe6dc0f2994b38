"""Inference engine: bucketed, chunked prefill and the decode loops
(counterpart of the JAX package's ``generation/engine.py``).

- **prefill**: the prompt is right-padded to a power-of-two bucket, and a
  prompt longer than ``CHUNK`` runs chunk by chunk against the cache.
- **generate**: the host loop, one forward and one sample per token, the
  token fetched to the host each step (stop tokens, streaming callback).
- **generate_device**: tokens stay on the card; a Python loop of forward +
  sample steps that synchronises once, at the end.

Sampling runs on the device in both loops (generation/sampling.py). The
family's forward comes from ``forward_for_family`` (llama, opt,
gptbigcode).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.generation import sampling
from tinychatengine_tpu_torch.models import gptbigcode, llama, opt
from tinychatengine_tpu_torch.utils.profiler import Profiler

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def forward_for_family(family: str):
    """Family -> its forward function (the families the port has)."""
    if family == "llama":
        return llama.forward
    if family == "opt":
        return opt.forward
    if family == "gptbigcode":
        return gptbigcode.forward
    raise ValueError(f"no generation driver for family {family!r}")


def raw_int8_kv(cfg: ModelConfig, qcfg: QuantConfig) -> bool:
    """OPT's SmoothQuant path stores raw int8 K/V with no scales (the
    static scales are folded into the BMM alphas); this is not the
    ``kv_cache_dtype="int8"`` mode, which keeps per-position scales."""
    return cfg.family == "opt" and qcfg.scheme == "w8a8"


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket")


@dataclasses.dataclass
class GenerationResult:
    tokens: list  # per-sequence list of generated token ids
    n_prompt: int
    ttft_s: float
    decode_s: float
    cache: object = None


def _penalty_window(gcfg: GenerationConfig) -> int:
    # -1 = context size; 0 disables penalties (the window stays all -1)
    return max(gcfg.n_ctx if gcfg.repeat_last_n < 0 else gcfg.repeat_last_n,
               1)


class Engine:
    """Single-model, single-device inference engine (llama, opt and
    gptbigcode).

    ``device`` defaults to the card and raises when there is none; CPU
    runs pass ``device="cpu"`` (params must already lie there).
    ``forward_fn`` defaults to the family's forward."""

    CHUNK = 2048  # long prompts prefill in chunks of this many tokens

    def __init__(self, params, cfg: ModelConfig,
                 qcfg: Optional[QuantConfig] = None, batch: int = 1,
                 max_len: Optional[int] = None, device=None, forward_fn=None):
        self._forward = forward_fn or forward_for_family(cfg.family)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.qcfg = qcfg or QuantConfig()
        self.batch = batch
        self.max_len = max_len or cfg.max_sqlen
        self.profiler = Profiler()

    def new_cache(self) -> kvc.KVCache:
        raw = raw_int8_kv(self.cfg, self.qcfg)
        return kvc.init_cache(
            self.cfg.num_layers, self.batch, self.max_len,
            self.cfg.num_kv_heads, self.cfg.head_dim,
            dtype=torch.int8 if raw else torch.bfloat16,
            quantized=not raw and self.qcfg.kv_cache_dtype == "int8",
            device=self.device)

    @torch.inference_mode()
    def prefill(self, input_ids: np.ndarray, cache: kvc.KVCache,
                start: int = 0):
        """input_ids [B, L] (unpadded). Returns (last-position logits
        [B, V], cache)."""
        b, n = input_ids.shape
        while n > self.CHUNK:
            head, input_ids = input_ids[:, :self.CHUNK], input_ids[:, self.CHUNK:]
            _, cache = self._forward(
                self.params, self.cfg, self._ids(head), cache, start,
                true_len=self.CHUNK)
            start += self.CHUNK
            n -= self.CHUNK
        ids = np.zeros((b, _bucket(n)), np.int64)
        ids[:, :n] = input_ids
        return self._forward(self.params, self.cfg, self._ids(ids), cache,
                             start, true_len=n)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _prompt_window(self, input_ids: np.ndarray, gcfg) -> np.ndarray:
        b, n_prompt = input_ids.shape
        window = _penalty_window(gcfg)
        last = np.full((b, window), -1, np.int64)
        if gcfg.repeat_last_n != 0:
            tail = min(window, n_prompt)
            last[:, window - tail:] = input_ids[:, n_prompt - tail:]
        return last

    @torch.inference_mode()
    def generate(self, input_ids, gcfg: GenerationConfig,
                 stop_token_ids: Sequence[int] = (),
                 on_token: Optional[Callable[[int], None]] = None,
                 cache: Optional[kvc.KVCache] = None,
                 start: int = 0) -> GenerationResult:
        """Streaming decode: prefill → [sample → forward]* until n_predict
        or a stop token."""
        input_ids = np.atleast_2d(np.asarray(input_ids, np.int64))
        b, n_prompt = input_ids.shape
        assert b == self.batch, (b, self.batch)
        if on_token is not None and b != 1:
            raise ValueError("on_token streaming requires batch == 1; "
                             "use per-row stop_token_ids for batched runs")
        if cache is None:
            cache = self.new_cache()
        state = sampling.SamplerState.init(gcfg.seed, b, gcfg.mirostat_tau,
                                           self.device)
        last_np = self._prompt_window(input_ids, gcfg)

        t0 = time.perf_counter()
        logits, cache = self.prefill(input_ids, cache, start=start)
        tok, state = sampling.sample(logits, state, gcfg,
                                     self._ids(last_np))
        tok_host = tok.cpu().numpy()
        ttft = time.perf_counter() - t0
        self.profiler.ttft_s = ttft

        out = [[] for _ in range(b)]
        stop = set(int(t) for t in stop_token_ids)
        finished = [False] * b
        t_decode0 = time.perf_counter()
        pos = start + n_prompt
        for _ in range(gcfg.n_predict):
            for i in range(b):
                if not finished[i]:
                    out[i].append(int(tok_host[i]))
                    if int(tok_host[i]) in stop:
                        finished[i] = True
            if on_token is not None and on_token(int(tok_host[0])) is False:
                break
            if all(finished) or pos + 1 >= self.max_len:
                break
            if gcfg.repeat_last_n != 0:
                last_np = np.roll(last_np, -1, axis=1)
                last_np[:, -1] = tok_host
            with self.profiler.section("decode"):
                logits, cache = self._forward(
                    self.params, self.cfg, self._ids(tok_host[:, None]),
                    cache, pos)
                tok, state = sampling.sample(logits, state, gcfg,
                                             self._ids(last_np))
                tok_host = tok.cpu().numpy()  # waits for the step
            pos += 1
        decode_s = time.perf_counter() - t_decode0
        return GenerationResult(tokens=out, n_prompt=n_prompt, ttft_s=ttft,
                                decode_s=decode_s, cache=cache)

    @torch.inference_mode()
    def generate_device(self, input_ids, gcfg: GenerationConfig,
                        n_tokens: Optional[int] = None,
                        cache: Optional[kvc.KVCache] = None,
                        return_cache: bool = False):
        """Prefill + n_tokens decode steps with the tokens kept on the card;
        nothing is fetched to the host inside the loop. Returns tokens
        [B, n_tokens] int32 on the engine's device (and the cache with
        return_cache). No early stop: the caller checks stop tokens."""
        input_ids = np.atleast_2d(np.asarray(input_ids, np.int64))
        b, n_prompt = input_ids.shape
        n_tokens = n_tokens or gcfg.n_predict
        if cache is None:
            cache = self.new_cache()
        # as in the JAX package: the prompt lands at position 0 and decode
        # continues from n_prompt, whatever the cache held before
        logits, cache = self.prefill(input_ids, cache)
        state = sampling.SamplerState.init(gcfg.seed, b, gcfg.mirostat_tau,
                                           self.device)
        last = self._ids(self._prompt_window(input_ids, gcfg))
        pos = n_prompt
        toks = []
        for _ in range(n_tokens):
            tok, state = sampling.sample(logits, state, gcfg, last)
            toks.append(tok)
            if gcfg.repeat_last_n != 0:
                last = torch.cat([last[:, 1:], tok[:, None].long()], dim=1)
            logits, cache = self._forward(self.params, self.cfg,
                                          tok[:, None].long(), cache, pos)
            pos += 1
        tokens = torch.stack(toks, dim=1)
        return (tokens, cache) if return_cache else tokens
