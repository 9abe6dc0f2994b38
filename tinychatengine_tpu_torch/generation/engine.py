"""Inference engine: bucketed, chunked prefill and the decode loops
(counterpart of the JAX package's ``generation/engine.py``).

- **prefill**: the prompt is right-padded to a power-of-two bucket, and a
  prompt longer than ``CHUNK`` runs chunk by chunk against the cache.
- **generate**: the host loop, one forward and one sample per token, the
  token fetched to the host each step (stop tokens, streaming callback).
- **generate_device**: tokens stay on the card and the host synchronises
  once, at the end.

On the card each prompt chunk (bucket, start) and the decode step (sample,
penalty window, forward at a device position) run as captured CUDA graphs
(``generation/cuda_graph.py``), the counterpart of JAX's jitted prefill
and its ``lax.scan``: ``generate_device`` replays the step n_tokens times,
``prefill`` one graph per chunk, all in one cache the engine owns. A
prompt given as ``input_embeds`` (a VLM's spliced prompt, llama family)
is chunked alongside its ids, its last chunk zero-padded to the bucket,
and its chunks replay graphs of their own (a bf16 [B, bucket, E] buffer
in place of the ids).
``cuda_graphs=False`` keeps the eager loops on the card, for comparisons;
on the CPU the loops are eager.
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
from tinychatengine_tpu_torch.generation import cuda_graph as cg
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


def ctx_cap_for(needed: int, max_len: int) -> int:
    """JAX's static decode bound: the power of two >= 512 covering
    ``needed`` positions, capped at ``max_len``."""
    cap = 512
    while cap < needed:
        cap *= 2
    return min(cap, max_len)


@dataclasses.dataclass
class GenerationResult:
    tokens: list  # per-sequence list of generated token ids
    n_prompt: int
    ttft_s: float
    decode_s: float
    cache: object = None

    @property
    def tokens_per_s(self) -> float:
        n = len(self.tokens[0]) if self.tokens else 0
        return n / self.decode_s if self.decode_s > 0 else 0.0


def _embeds_kw(embeds) -> dict:
    """The forward's ``input_embeds`` keyword, only when there are embeds
    (the families without them take no such keyword)."""
    return {} if embeds is None else {"input_embeds": embeds}


def _penalty_window(gcfg: GenerationConfig) -> int:
    # -1 = context size; 0 disables penalties (the window stays all -1)
    return max(gcfg.n_ctx if gcfg.repeat_last_n < 0 else gcfg.repeat_last_n,
               1)


def _static_fields(gcfg: GenerationConfig) -> tuple:
    """The sampling fields a captured step bakes in: all but the seed (the
    generator is seeded before each run) and n_predict."""
    out = []
    for f in dataclasses.fields(gcfg):
        v = getattr(gcfg, f.name)
        if f.name in ("seed", "n_predict"):
            continue
        if f.name == "logit_bias" and v:
            v = tuple(sorted((int(t), float(b)) for t, b in (
                v.items() if hasattr(v, "items") else v)))
        out.append((f.name, v))
    return tuple(out)


class DecodeStep:
    """``generate_device``'s step over static buffers: sample from
    ``logits`` (with the penalty window ``last``), write the token at
    column ``index`` of ``out``, update the window, run the forward at the
    device positions ``pos`` [B] int32, advance both. ``body`` is what the
    card captures; it runs eagerly anywhere (the CPU tests)."""

    def __init__(self, eng: "Engine", cache, logits_shape, gcfg, ctx_cap):
        dev = eng.device
        b = logits_shape[0]
        # the engine's model, not the engine: no reference cycle through
        # its graphs
        self.model = (eng._forward, eng.params, eng.cfg)
        self.cache, self.gcfg, self.ctx_cap = cache, gcfg, ctx_cap
        self.logits = torch.zeros(logits_shape, dtype=torch.float32,
                                  device=dev)
        self.last = torch.full((b, _penalty_window(gcfg)), -1,
                               dtype=torch.int64, device=dev)
        self.pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.out = torch.zeros((b, cache.max_len), dtype=torch.int32,
                               device=dev)
        self.sampler = sampling.SamplerState.init(gcfg.seed, b,
                                                  gcfg.mirostat_tau, dev)
        self.bias = sampling.logit_bias_tensors(gcfg, dev)

    def reset(self, logits, last: np.ndarray, pos: int, seed: int) -> None:
        """A run's start: the prefill's logits, the prompt's window, the
        first decode position, a fresh generator and mirostat mu."""
        self.logits.copy_(logits)
        self.last.copy_(torch.from_numpy(last))
        self.pos.fill_(pos)
        self.index.zero_()
        self.sampler.mu.fill_(2.0 * self.gcfg.mirostat_tau)
        self.sampler.gen.manual_seed(max(seed, 0))

    def body(self) -> None:
        tok, state = sampling.sample(self.logits, self.sampler, self.gcfg,
                                     self.last, bias=self.bias)
        if state.mu is not self.sampler.mu:
            self.sampler.mu.copy_(state.mu)
        self.out.index_copy_(1, self.index, tok[:, None])
        if self.gcfg.repeat_last_n != 0:  # 0 = penalties disabled
            self.last.copy_(torch.cat([self.last[:, 1:], tok[:, None].long()],
                                      dim=1))
        forward, params, cfg = self.model
        logits, _ = forward(params, cfg, tok[:, None].long(), self.cache,
                            self.pos, ctx_cap=self.ctx_cap)
        self.logits.copy_(logits)
        self.pos.add_(1)
        self.index.add_(1)


class PrefillStep:
    """One prompt chunk of ``bucket`` ids at host position ``start`` over
    static buffers: ``ids`` [B, bucket], ``true_len`` (0-d int32, read on
    the device only), ``logits`` [B, V] of each row's last real position;
    with ``embed_dim``, ``embeds`` [B, bucket, E] bf16 go to the forward as
    ``input_embeds``."""

    def __init__(self, eng: "Engine", cache, b: int, bucket: int,
                 start: int, embed_dim: int = 0):
        dev = eng.device
        self.model = (eng._forward, eng.params, eng.cfg)
        self.cache, self.start = cache, start
        self.ids = torch.zeros((b, bucket), dtype=torch.int64, device=dev)
        self.embeds = (torch.zeros((b, bucket, embed_dim),
                                   dtype=torch.bfloat16, device=dev)
                       if embed_dim else None)
        self.true_len = torch.zeros((), dtype=torch.int32, device=dev)
        self.logits = None

    def body(self) -> None:
        forward, params, cfg = self.model
        logits, _ = forward(params, cfg, self.ids, self.cache, self.start,
                            true_len=self.true_len,
                            **_embeds_kw(self.embeds))
        if self.logits is None:  # made outside the capture: the eager run
            self.logits = torch.empty_like(logits)
        self.logits.copy_(logits)


class Engine:
    """Single-model, single-device inference engine (llama, opt and
    gptbigcode).

    ``device`` defaults to the card and raises when there is none; CPU
    runs pass ``device="cpu"`` (params must already lie there).
    ``forward_fn`` defaults to the family's forward. ``kv_dtype``: the
    cache's storage dtype, stored raw with no scales (JAX's ``kv_dtype``;
    default None: OPT W8A8's raw int8, else bf16, or int8 with scales under
    ``qcfg.kv_cache_dtype="int8"``). ``cuda_graphs``: on the card,
    ``prefill`` and ``generate_device`` replay captured CUDA graphs
    (``graphs``); False keeps the eager loops, for comparisons. The graphs
    run in one cache the engine owns (its storage is what they captured),
    so every call replays them: a caller's cache is copied in (the
    positions the call reads) and out (the positions it wrote), and a cache
    handed back is the caller's or a fresh copy, never the engine's."""

    CHUNK = 2048  # long prompts prefill in chunks of this many tokens

    def __init__(self, params, cfg: ModelConfig,
                 qcfg: Optional[QuantConfig] = None, batch: int = 1,
                 max_len: Optional[int] = None, device=None, forward_fn=None,
                 kv_dtype=None, cuda_graphs: bool = True):
        self._forward = forward_fn or forward_for_family(cfg.family)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.qcfg = qcfg or QuantConfig()
        self.batch = batch
        self.max_len = max_len or cfg.max_sqlen
        self.kv_dtype = kv_dtype
        if kv_dtype is None and raw_int8_kv(cfg, self.qcfg):
            self.kv_dtype = torch.int8
        self.profiler = Profiler()
        self.graphs = (cg.Graphs(self.device)
                       if cuda_graphs and self.device.type == "cuda" else None)
        self._cache = None  # the graph path's own cache (``_own_cache``)
        self._cache_default = True  # made by new_cache, not like a caller's

    def new_cache(self) -> kvc.KVCache:
        if self.kv_dtype is not None:
            return kvc.init_cache(
                self.cfg.num_layers, self.batch, self.max_len,
                self.cfg.num_kv_heads, self.cfg.head_dim,
                dtype=self.kv_dtype, device=self.device)
        return kvc.init_cache(
            self.cfg.num_layers, self.batch, self.max_len,
            self.cfg.num_kv_heads, self.cfg.head_dim,
            quantized=self.qcfg.kv_cache_dtype == "int8",
            device=self.device)

    def _own_cache(self, like: Optional[kvc.KVCache] = None
                   ) -> kvc.KVCache:
        """The graph path's cache, of ``like``'s layout (the engine's own,
        ``new_cache``'s, without one). Another layout remakes it and drops
        the steps captured on the old one."""
        own = self._cache
        if own is not None and (not self._cache_default if like is None else
                                kvc.layout(like) != kvc.layout(own)):
            self.graphs.clear()
            own = self._cache = None
        if own is None:
            own = self.new_cache() if like is None else kvc.fresh_like(like)
            self._cache, self._cache_default = own, like is None
        return own

    @torch.inference_mode()
    def prefill(self, input_ids: np.ndarray, cache: kvc.KVCache,
                start: int = 0, input_embeds=None):
        """input_ids [B, L] (unpadded); input_embeds: optional [B, L, E]
        (a tensor or an array, cast to bf16) in place of the embedding
        gather. Returns (last-position logits [B, V], cache). On the graph
        path the chunks run in the engine's cache: positions [0, start) are
        copied in from ``cache`` and the prompt's positions back out to
        it."""
        embeds = self._embeds(input_embeds)
        if self.graphs is None:
            return self._prefill(input_ids, cache, start, embeds)
        own = self._own_cache(cache)
        kvc.copy_positions(cache, own, 0, start)
        own.length = cache.length
        logits, _ = self._prefill(input_ids, own, start, embeds)
        kvc.copy_positions(own, cache, start, start + np.shape(input_ids)[1])
        cache.length = own.length
        return logits, cache

    def _embeds(self, input_embeds) -> Optional[torch.Tensor]:
        """A prompt's embeds as bf16 on the engine's device (or None)."""
        if input_embeds is None:
            return None
        if not isinstance(input_embeds, torch.Tensor):
            input_embeds = torch.from_numpy(np.asarray(input_embeds))
        return input_embeds.to(self.device, torch.bfloat16)

    def _prefill(self, input_ids: np.ndarray, cache: kvc.KVCache,
                 start: int, embeds: Optional[torch.Tensor] = None):
        """The chunks of ``prefill`` in ``cache``: through their graphs
        (the engine's cache only) or eager. ``embeds`` [B, L, E] bf16 are
        cut into the same chunks, the last zero-padded to its bucket."""
        b, n = input_ids.shape
        while n > self.CHUNK:
            head, input_ids = input_ids[:, :self.CHUNK], input_ids[:, self.CHUNK:]
            he = None
            if embeds is not None:
                he, embeds = embeds[:, :self.CHUNK], embeds[:, self.CHUNK:]
            if self.graphs is not None:
                self._prefill_graph(head, cache, start, self.CHUNK, he)
            else:
                _, cache = self._forward(
                    self.params, self.cfg, self._ids(head), cache, start,
                    true_len=self.CHUNK, **_embeds_kw(he))
            start += self.CHUNK
            n -= self.CHUNK
        bucket = _bucket(n)
        ids = np.zeros((b, bucket), np.int64)
        ids[:, :n] = input_ids
        if embeds is not None:
            embeds = torch.nn.functional.pad(embeds, (0, 0, 0, bucket - n))
        if self.graphs is not None:
            return self._prefill_graph(ids, cache, start, n, embeds), cache
        return self._forward(self.params, self.cfg, self._ids(ids), cache,
                             start, true_len=n, **_embeds_kw(embeds))

    def _prefill_graph(self, ids: np.ndarray, cache: kvc.KVCache, start: int,
                       n: int, embeds: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """One chunk through its captured graph, keyed by (cache, batch,
        bucket, start, the embeds' width or 0): ids, the embeds and the
        real length go into the static buffers; the cache's host length
        advances by n, as the eager forward advances it."""
        b, bucket = ids.shape
        e = 0 if embeds is None else embeds.shape[-1]
        key = ("prefill", cg.storage_key(cache.k, cache.v, cache.k_scale),
               b, bucket, start, e, cg.routes())

        def build():
            st = PrefillStep(self, cache, b, bucket, start, e)
            return cg.Step(st.body, st)
        step = self.graphs.step(key, build)
        step.state.ids.copy_(torch.from_numpy(np.asarray(ids, np.int64)))
        if embeds is not None:
            step.state.embeds.copy_(embeds)
        step.state.true_len.fill_(n)
        self.graphs.run(step)
        cache.length += n
        return step.state.logits.clone()

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
                 start: int = 0, input_embeds=None) -> GenerationResult:
        """Streaming decode: prefill → [sample → forward]* until n_predict
        or a stop token. input_embeds: the prompt's [B, L, E] embeddings
        (``prefill``)."""
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
        logits, cache = self.prefill(input_ids, cache, start=start,
                                     input_embeds=input_embeds)
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
                        return_cache: bool = False, input_embeds=None):
        """Prefill + n_tokens decode steps with the tokens kept on the card;
        nothing is fetched to the host inside the loop. Returns tokens
        [B, n_tokens] int32 on the engine's device (and the cache with
        return_cache). No early stop: the caller checks stop tokens.
        n_prompt + n_tokens > max_len raises ``ValueError`` before any
        step. On the card the step is one captured graph (``DecodeStep``),
        replayed n_tokens times in the engine's cache, whose positions
        [0, n_prompt + n_tokens) are then copied to ``cache`` (or to a
        fresh copy with return_cache); ``ctx_cap`` (``ctx_cap_for``) bounds
        the attention grid as in JAX. input_embeds: the prompt's [B, L, E]
        embeddings (``prefill``)."""
        input_ids = np.atleast_2d(np.asarray(input_ids, np.int64))
        b, n_prompt = input_ids.shape
        n_tokens = n_tokens or gcfg.n_predict
        base = 0 if cache is None else cache.length
        max_len = self.max_len if cache is None else cache.max_len
        if n_prompt + n_tokens > max_len:
            raise ValueError(f"KV cache full: {n_prompt} prompt + {n_tokens} "
                             f"decode positions > max_len {max_len}")
        ctx_cap = ctx_cap_for(base + n_prompt + n_tokens, self.max_len)
        window = self._prompt_window(input_ids, gcfg)
        # as in the JAX package: the prompt lands at position 0 and decode
        # continues from n_prompt, whatever the cache held before
        if self.graphs is not None:
            own = self._own_cache(cache)
            own.length = base
            logits, _ = self._prefill(input_ids, own, 0,
                                      self._embeds(input_embeds))
            tokens = self._decode_graph(own, logits, window, n_prompt,
                                        n_tokens, gcfg, ctx_cap)
            if cache is not None:
                kvc.copy_positions(own, cache, 0, n_prompt + n_tokens)
                cache.length = own.length
            elif return_cache:
                cache = kvc.clone(own)
            return (tokens, cache) if return_cache else tokens
        if cache is None:
            cache = self.new_cache()
        logits, cache = self.prefill(input_ids, cache,
                                     input_embeds=input_embeds)
        state = sampling.SamplerState.init(gcfg.seed, b, gcfg.mirostat_tau,
                                           self.device)
        last = self._ids(window)
        pos = n_prompt
        toks = []
        for _ in range(n_tokens):
            tok, state = sampling.sample(logits, state, gcfg, last)
            toks.append(tok)
            if gcfg.repeat_last_n != 0:
                last = torch.cat([last[:, 1:], tok[:, None].long()], dim=1)
            logits, cache = self._forward(self.params, self.cfg,
                                          tok[:, None].long(), cache, pos,
                                          ctx_cap=ctx_cap)
            pos += 1
        tokens = torch.stack(toks, dim=1)
        return (tokens, cache) if return_cache else tokens

    def _decode_graph(self, cache, logits, window, n_prompt: int,
                      n_tokens: int, gcfg, ctx_cap: int) -> torch.Tensor:
        """n_tokens replays of the decode step keyed by (cache, logits
        shape, ctx_cap, the sampler's static fields); the cache's host
        length ends n_tokens on, as the eager loop's forwards leave it (a
        capture runs the body twice, eager and captured, and each run's
        forward advances it)."""
        key = ("decode", cg.storage_key(cache.k, cache.v, cache.k_scale),
               tuple(logits.shape), ctx_cap, _static_fields(gcfg),
               cg.routes())

        def build():
            st = DecodeStep(self, cache, tuple(logits.shape), gcfg, ctx_cap)
            gens = (st.sampler.gen,) if gcfg.temp > 0 else ()
            return cg.Step(st.body, st, gens)
        step = self.graphs.step(key, build)
        step.state.reset(logits, window, n_prompt, gcfg.seed)
        length = cache.length
        for _ in range(n_tokens):
            self.graphs.run(step)
        cache.length = length + n_tokens
        return step.state.out[:, :n_tokens].clone()
