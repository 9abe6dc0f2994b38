"""Serving runtime: continuous batching over slot-based KV (counterpart of
the JAX package's ``runtime/serving.py``).

- a fixed pool of B decode *slots*, each a row of one shared KV cache
  [L, B, H_kv, S_max, D], or (``paged=True``) a pool of pages that
  sequences borrow as they grow (``runtime/paged.py``);
- **continuous batching**: a request is admitted the moment a slot frees.
  Admission prefills the prompt into a B = 1 scratch cache, chunk by chunk
  (one chunk per scheduler tick, interleaved with decode), then splices
  the prefix into the slot or its pages; several short prompts at the
  queue head are admitted together by one ragged batched prefill (dense);
- **ragged decode**: one forward decodes every slot at its own position
  (per-row ``start``; per-row lengths into ``flash_decode`` or
  ``flash_decode_paged``);
- inactive slots still run (dead rows keep the batch shape) but their
  cache writes land beyond their frozen lengths, or on the reserved dead
  page, and their outputs are discarded;
- **bursts**: when no admission can run, K decode+sample ticks run back to
  back with no host synchronisation inside, and the [K, B] tokens are
  fetched once. On the card a tick with the per-row sampler is one
  captured CUDA graph (``Tick``, keyed by the sampler's stage gates and
  the dense ``ctx_cap`` bucket), replayed K times, and once for a single
  tick (``cuda_graphs=False`` keeps the eager ticks); admission, the
  prefix cache and the engine-global sampler stay eager;
- **prefix cache** (``prefix_cache_entries > 0``): after an admission the
  prompt's KV head is kept in a pool of entries (the scratch cache's
  storage: bf16, int8 codes with their scales, or OPT's raw int8); a later
  prompt that shares at least ``prefix_min`` leading tokens with an entry
  starts its prefill from a copy of that KV and prefills only its tail;
- **logprobs** (``submit(logprobs=k)``, k <= ``logprobs_k``): each
  emitted token's log-probability under the raw model logits (before any
  sampling stage) and the top k alternatives, ties ordered as
  ``lax.top_k`` orders them (value descending, then index ascending), on
  every path that emits (the tick and the burst, whose captured graphs
  take a logprobs variant keyed on ``logprobs_k``, and the first token of
  each admission, single or batched, dense or paged);
- **speculative ticks** (``speculative=True``, dense, per-row sampler):
  while every active row is greedy with no penalty, bias or logprobs, one
  ragged [B, K+1] forward verifies ``spec_K`` prompt-lookup drafts per row
  (``generation/speculative.py verify``), as a captured graph keyed on K
  on the card; a row emits its accepted drafts plus one;
- **multimodal prompts** (``submit(input_embeds=...)``, llama family):
  [n, E] embeddings replace the embedding gather for the whole prompt;
  such a request takes the single admission, its chunks carry their
  embeds, it bypasses the prefix cache, and a preempted one resumes with
  the table rows of its emitted tokens appended.

Sampling is per request (``sampling.sample_rows``): every parameter rides
as a [slots] tensor, and each request carries its own (key, step) random
stream, so its tokens do not depend on its slot, its neighbours or on how
ticks were grouped into bursts. An engine-level logit_bias table larger
than ``RowParams.MAX_BIAS`` keeps the engine-global sampler instead.

The model runs through ``forward_fn`` (``llama.forward`` by default, as in
the JAX package; ``opt.forward`` for OPT, ``gptbigcode.forward`` for
StarCoder, dense or paged, with single admissions). OPT W8A8 serves from a
dense slot cache of raw int8 K/V; it has no paged path (``paged=True``
raises ``NotImplementedError``, as in JAX).

Not ported: sequence-parallel admission (``sp_mesh`` raises
``NotImplementedError``).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Callable, Optional

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.generation import cuda_graph as cg
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.generation import sampling
from tinychatengine_tpu_torch.generation import speculative as spec
from tinychatengine_tpu_torch.generation.engine import (Engine, _bucket,
                                                        ctx_cap_for,
                                                        raw_int8_kv)
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.runtime import paged as pg


@dataclasses.dataclass(eq=False)  # identity equality: two requests with
# equal fields are still two requests (deque.remove must not alias them)
class Request:
    """One generation request."""

    prompt_ids: np.ndarray                    # [n] int
    n_predict: int
    # a multimodal prompt: [n, E] f32 embeddings of the whole prompt (the
    # text's table rows with the image's spliced in); prompt_ids then hold
    # 0 at image positions and feed only the penalty window
    input_embeds: Optional[np.ndarray] = None
    stop_token_ids: tuple = ()
    on_token: Optional[Callable[[int, "Request"], None]] = None
    request_id: int = 0
    gcfg: Optional[GenerationConfig] = None   # per-request sampling params
    logprobs: Optional[int] = None  # None: off; 0: chosen token only
    # filled by the engine:
    output_ids: list = dataclasses.field(default_factory=list)
    output_logprobs: list = dataclasses.field(default_factory=list)
    # per emitted token: [(token id, logprob)] of length ``logprobs``
    output_top_logprobs: list = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None       # "stop" | "length" | ...
    submit_t: float = 0.0
    first_token_t: float = 0.0
    done_t: float = 0.0


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    length: int = 0          # valid KV positions
    remaining: int = 0
    admitting: bool = False  # reserved for an in-flight chunked admission

    @property
    def active(self) -> bool:
        return self.request is not None and not self.admitting


class ServingEngine:
    """Continuous-batching server for one model replica (llama, opt and
    gptbigcode).

    ``device`` defaults to the card and raises when there is none; CPU runs
    pass ``device="cpu"`` (params must already lie there).

    paged: a page pool (``page_size`` positions per page, ``n_pages`` pages,
    default the dense-equivalent slots * ceil(max_len / page_size)) in
    place of the slots x max_len cache; page 0 is the dead page that
    inactive rows point at. admission_chunk: a long prompt prefills one
    chunk of this many tokens per tick. tick_batch: the largest decode
    burst (1 disables bursts).

    prefix_cache_entries: the KV prefix cache's entries (0: none). After
    each single admission the prompt's first ``prefix_cache_len`` (default
    ``max_len``) positions of KV are stored; a later prompt whose longest
    common token prefix with an entry is >= ``prefix_min`` (capped at its
    length - 1, so a tail remains to give the first token's logits) copies
    that KV into its prefill and prefills only the rest. Causality makes
    KV[0:m) a function of tokens[0:m) alone. LRU eviction; counters in
    ``prefix_stats``. A hit bypasses batched admission.

    speculative: prompt-lookup draft-and-verify ticks of ``spec_K`` drafts
    (dense, per-row sampler; off for paged serving and the engine-global
    sampler, as in JAX); counters in ``_spec_stats``. logprobs_k: the
    widest top-k a request may ask for (every logprobs variant computes
    this many).

    cuda_graphs: on the card, the per-row decode tick and the speculative
    tick replay captured graphs (``Tick``, ``SpecTick``; ``graphs`` holds
    them); False keeps them eager, for comparisons."""

    def __init__(self, params, cfg: ModelConfig,
                 qcfg: Optional[QuantConfig] = None, slots: int = 8,
                 max_len: Optional[int] = None,
                 gcfg: Optional[GenerationConfig] = None,
                 forward_fn=llama.forward, paged: bool = False,
                 page_size: int = 128,
                 n_pages: Optional[int] = None, admission_chunk: int = 512,
                 tick_batch: int = 8, speculative: bool = False,
                 spec_K: int = 7, prefix_cache_entries: int = 0,
                 prefix_cache_len: Optional[int] = None,
                 prefix_min: int = 64, logprobs_k: int = 8, sp_mesh=None,
                 device=None, cuda_graphs: bool = True):
        if sp_mesh is not None:
            raise NotImplementedError(
                "sequence-parallel admission is not ported")
        if cfg.family not in ("llama", "opt", "gptbigcode"):
            raise ValueError(f"ServingEngine serves the llama, opt and "
                             f"gptbigcode families, not {cfg.family!r}")
        if cfg.family != "llama" and forward_fn is llama.forward:
            raise ValueError(f"pass the {cfg.family} forward as forward_fn")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.qcfg = qcfg or QuantConfig()
        self.n_slots = slots
        self.max_len = max_len or cfg.max_sqlen
        self.gcfg = gcfg or GenerationConfig()
        self.paged = paged
        self._forward = forward_fn

        raw_int8 = raw_int8_kv(cfg, self.qcfg)
        quantized = not raw_int8 and self.qcfg.kv_cache_dtype == "int8"
        if paged and raw_int8:
            raise NotImplementedError(
                "OPT W8A8's static-scale int8 KV attention (int8_decode) "
                "has no paged variant: OPT serves with the dense slot cache")
        if paged:
            self.max_pages = -(-self.max_len // page_size)
            n_pages = n_pages or slots * self.max_pages
            self.page_cache = pg.init_paged_cache(
                cfg.num_layers, n_pages, cfg.num_kv_heads, page_size,
                cfg.head_dim, quantized=quantized, device=self.device)
            self.allocator = pg.PageAllocator(n_pages, page_size,
                                              self.max_pages)
            # the reserved dead page: inactive slots' table rows point at
            # it, so their dummy decode writes never touch live pages
            self._dead_page = self.allocator.alloc(1)[0]
            self._tables = np.full((slots, self.max_pages), self._dead_page,
                                   np.int32)
            self._slot_pages: list[list[int]] = [[] for _ in range(slots)]
            self.cache = None
        else:
            self.cache = kvc.init_cache(
                cfg.num_layers, slots, self.max_len, cfg.num_kv_heads,
                cfg.head_dim, dtype=torch.int8 if raw_int8 else torch.bfloat16,
                quantized=quantized, device=self.device)
        # single-request prefill engine writing into a scratch cache
        self._prefill_engine = Engine(params, cfg, self.qcfg, batch=1,
                                      max_len=self.max_len,
                                      device=self.device,
                                      forward_fn=forward_fn,
                                      cuda_graphs=False)
        self._scratch = self._prefill_engine.new_cache()

        self.slots = [_Slot() for _ in range(slots)]
        # what the scheduler spent its ticks on
        self.tick_stats = {"bursts": 0, "burst_ticks": 0, "single_ticks": 0,
                           "admit_chunks": 0, "batch_admits": 0,
                           "batch_admit_reqs": 0, "spec_ticks": 0}
        self.queue: collections.deque[Request] = collections.deque()
        self.done: list[Request] = []
        self._ids = itertools.count()
        self.admission_chunk = admission_chunk
        self._pending = None  # in-flight chunked admission: [slot_idx, done]

        # repeat_last_n < 0 means the context size: size the shared
        # history window accordingly
        window = max(self._resolve_window(self.gcfg), 1)
        self._last = np.full((slots, window), -1, np.int64)
        self._next_tok = np.zeros((slots,), np.int64)
        self._row_window = np.full((slots,), window, np.int64)
        # per-request sampling; an oversized engine-level bias table keeps
        # the engine-global sampler for every request instead
        self._per_row = (len(self.gcfg.logit_bias or ())
                         <= sampling.RowParams.MAX_BIAS)
        self._row_cfgs = [self.gcfg] * slots
        self._row_params = sampling.RowParams.from_configs(self._row_cfgs,
                                                           self.device)
        self._mu = torch.full((slots,), 2.0 * self.gcfg.mirostat_tau,
                              dtype=torch.float32, device=self.device)
        self._keys = sampling.row_keys(max(self.gcfg.seed, 0), slots,
                                       self.device)
        self._state = sampling.SamplerState.init(
            self.gcfg.seed, slots, self.gcfg.mirostat_tau, self.device)
        self.tick_batch = max(int(tick_batch), 1)
        self.graphs = (cg.Graphs(self.device)
                       if cuda_graphs and self.device.type == "cuda" else None)
        # batched admission: R queue-head single-chunk prompts in one ragged
        # prefill (dense cache, per-row sampler and llama only, as in JAX)
        self._batch_admit = (self._per_row and not paged
                             and forward_fn is llama.forward)
        self._multi_scratch: dict[int, kvc.KVCache] = {}

        # prefix cache: a KVCache whose batch axis is the entry pool, in
        # the scratch cache's storage
        self._pfx_entries = int(prefix_cache_entries)
        self._prefix_min = int(prefix_min)
        if self._pfx_entries:
            w = min(prefix_cache_len or self.max_len, self.max_len)
            self._pfx_store = kvc.init_cache(
                cfg.num_layers, self._pfx_entries, w, cfg.num_kv_heads,
                cfg.head_dim, dtype=self._scratch.k.dtype,
                quantized=self._scratch.quantized, device=self.device)
            self._pfx_tokens: list[Optional[np.ndarray]] = \
                [None] * self._pfx_entries
            self._pfx_lru: list[int] = list(range(self._pfx_entries))
            self.prefix_stats = {"hits": 0, "hit_tokens": 0, "stores": 0}

        self.logprobs_k = int(logprobs_k)
        # speculative (prompt-lookup) ticks: each row's lookup history lives
        # on the device; a row's is rebuilt from the host record after any
        # tick that is not speculative
        self.speculative = bool(speculative) and not paged and self._per_row
        self.spec_K = int(spec_K)
        if self.spec_K + 1 >= 16:
            raise ValueError("spec_K + 1 must stay below the smallest bucket")
        self._row_greedy = [False] * slots
        if self.speculative:
            self.hist_len = self.max_len + self.spec_K + 1
            self._hist = torch.zeros((slots, self.hist_len),
                                     dtype=torch.int64, device=self.device)
            self._h = np.zeros((slots,), np.int64)
            self._hist_dirty = [True] * slots
            self._in_spec = False
            self._spec_stats = {"ticks": 0, "tokens": 0}

    def _resolve_window(self, g: GenerationConfig) -> int:
        """Penalty-history window for a config: -1 = context size, 0 =
        penalties disabled (the window stays all -1)."""
        return min(g.n_ctx, self.max_len) if g.repeat_last_n < 0 \
            else g.repeat_last_n

    # -- public API ----------------------------------------------------------
    def submit(self, prompt_ids, n_predict: Optional[int] = None,
               stop_token_ids=(), on_token=None,
               gcfg: Optional[GenerationConfig] = None,
               logprobs: Optional[int] = None,
               input_embeds=None) -> Request:
        """Queue a request. gcfg: its own sampling parameters. logprobs: the
        chosen token's logprob under the raw model for every emitted token,
        and the top ``logprobs`` alternatives when > 0 (at most
        ``logprobs_k``). input_embeds: [n, E] (or [1, n, E]) embeddings of
        the whole prompt in place of the embedding gather."""
        if gcfg is not None:
            if not self._per_row:
                raise ValueError(
                    "per-request gcfg unavailable: the engine gcfg uses the "
                    "engine-global sampler (oversized logit_bias)")
            if len(gcfg.logit_bias or ()) > sampling.RowParams.MAX_BIAS:
                raise ValueError(
                    f"per-request logit_bias supports at most "
                    f"{sampling.RowParams.MAX_BIAS} entries")
        if logprobs is not None and not 0 <= int(logprobs) <= self.logprobs_k:
            raise ValueError(
                f"logprobs must be in [0, {self.logprobs_k}] "
                f"(engine logprobs_k); got {logprobs}")
        ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        if input_embeds is not None:
            if isinstance(input_embeds, torch.Tensor):
                input_embeds = input_embeds.float().cpu().numpy()
            input_embeds = np.asarray(input_embeds, np.float32)
            if input_embeds.ndim == 3 and input_embeds.shape[0] == 1:
                input_embeds = input_embeds[0]
            if input_embeds.shape != (len(ids), self.cfg.embed_dim):
                raise ValueError(
                    f"input_embeds must be [{len(ids)}, "
                    f"{self.cfg.embed_dim}]; got {input_embeds.shape}")
        req = Request(
            prompt_ids=ids, input_embeds=input_embeds,
            n_predict=n_predict or (gcfg or self.gcfg).n_predict,
            stop_token_ids=tuple(int(t) for t in stop_token_ids),
            on_token=on_token, request_id=next(self._ids), gcfg=gcfg,
            logprobs=None if logprobs is None else int(logprobs),
            submit_t=time.perf_counter())
        self.queue.append(req)
        return req

    def run(self) -> list:
        """Drain the queue; returns finished requests in completion order."""
        while (self.queue or self._pending is not None
               or any(s.active for s in self.slots)):
            self.step()
        return self.done

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Abort a request at any stage (queued, mid-admission, decoding).
        Returns True if it was live and is now finished, False if it had
        already finished."""
        if req.finished:
            return False
        done = False
        try:  # still queued (or requeued by preemption)
            self.queue.remove(req)
            done = True
        except ValueError:
            pass
        if not done and self._pending is not None \
                and self.slots[self._pending[0]].request is req:
            # in-flight chunked admission: only prefill work is lost
            slot_idx = self._pending[0]
            self._pending = None
            slot = self.slots[slot_idx]
            slot.request = None
            slot.admitting = False
            if self.paged:
                self.allocator.free(self._slot_pages[slot_idx])
                self._slot_pages[slot_idx] = []
            done = True
        if not done:
            for i, slot in enumerate(self.slots):
                if slot.request is req:  # active: free the slot mid-stream
                    slot.request = None
                    slot.length = 0
                    if self.paged:
                        self._release_pages(i)
                    done = True
                    break
        if not done:
            return False
        req.finished = True
        req.finish_reason = reason
        req.done_t = time.perf_counter()
        self.done.append(req)
        return True

    # -- scheduler core --------------------------------------------------------
    @torch.inference_mode()
    def step(self):
        """One scheduler tick: advance at most one admission prefill chunk,
        then one batched decode step (or a burst) for every active slot.
        Page-pool exhaustion applies backpressure: admission waits, decode
        growth preempts (the preempted request resumes with its progress)."""
        if self._pending is not None:
            self._admit_chunk()
        while (self._pending is None and self.queue
               and self._free_slot() is not None):
            if self.paged and self.allocator.n_free < \
                    self.allocator.pages_needed(
                        _bucket(min(len(self.queue[0].prompt_ids),
                                    self.max_len - 2))):
                break  # not enough pages: hold the queue until some free
            batch = self._eligible_batch()
            if len(batch) >= 2:
                self._admit_batch(batch)
                continue
            self._begin_admission(self._free_slot(), self.queue.popleft())
            if self._pending is not None:
                break  # a long prompt: its chunks continue on later ticks
        if not any(s.active for s in self.slots):
            if self.queue and self._pending is None:
                raise MemoryError(
                    "paged KV pool cannot fit the next request's prefill "
                    f"({self.allocator.n_free} pages free)")
            return
        if self._spec_ok():
            self._decode_spec()
            return
        k = self._burst_ticks()
        if k >= 2:
            self.tick_stats["bursts"] += 1
            self.tick_stats["burst_ticks"] += k
            self._decode_burst(k)
        else:
            self.tick_stats["single_ticks"] += 1
            self._decode_once()

    # -- speculative (prompt-lookup) ticks -------------------------------------
    def _spec_ok(self) -> bool:
        """A speculative tick needs: speculation on, no pending admission
        and none possible now, and every active row greedy with no logprobs
        and K + 1 positions of cache and history to spare."""
        if not self.speculative or self._pending is not None:
            return False
        if self.queue and self._free_slot() is not None:
            return False
        act = [i for i, s in enumerate(self.slots) if s.active]
        if not act:
            return False
        for i in act:
            s = self.slots[i]
            if not self._row_greedy[i] or s.request.logprobs is not None:
                return False
            if s.length + self.spec_K + 1 >= self.max_len:
                return False
            if self._h[i] + self.spec_K + 1 > self.hist_len:
                return False
        return True

    def _refresh_hist(self, i: int):
        """Rebuild slot i's device history from the host record (prompt and
        emitted tokens): after its admission and after any tick that was
        not speculative."""
        req = self.slots[i].request
        n = len(req.prompt_ids)
        row = np.zeros((self.hist_len,), np.int64)
        row[:n] = req.prompt_ids
        row[n:n + len(req.output_ids)] = req.output_ids
        self._hist[i].copy_(torch.from_numpy(row))
        self._h[i] = n + len(req.output_ids)
        self._hist_dirty[i] = False

    def _decode_spec(self):
        """One draft-and-verify tick over every slot (``SpecTick``: a
        captured graph keyed on K on the card, else eager). A row emits its
        accepted drafts and one more token; a row that stops mid-run
        discards the rest, as in bursts."""
        for i, s in enumerate(self.slots):
            if s.active and self._hist_dirty[i]:
                self._refresh_hist(i)
        active0 = [s.active for s in self.slots]
        if self.graphs is not None:
            def build():
                t = SpecTick(self)
                return cg.Step(t.body, t)
            step = self.graphs.step(("spec", self.spec_K, cg.routes()),
                                    build)
            step.state.load(self)
            self.graphs.run(step)
            tick = step.state
        else:
            tick = SpecTick(self)
            tick.load(self)
            tick.body()
        seq = tick.seq.cpu().numpy()                       # [B, K+1]
        emitted = tick.emitted.cpu().numpy()
        self._in_spec = True
        try:
            for i, slot in enumerate(self.slots):
                if not active0[i]:
                    continue
                self._h[i] += int(emitted[i])
                for t in range(int(emitted[i])):
                    if not slot.active:
                        break              # stopped mid-run: discard the rest
                    slot.length += 1
                    self._emit(i, int(seq[i, t]))
                    self._spec_stats["tokens"] += 1
        finally:
            self._in_spec = False
        self._spec_stats["ticks"] += 1
        self.tick_stats["spec_ticks"] += 1

    def _burst_ticks(self) -> int:
        """How many decode ticks can run as one burst without the host
        stepping in: the per-row sampler, no in-flight chunked admission,
        no admission possible right now, and tick_batch tokens of budget
        and cache/page headroom on every active slot. Rounded down to a
        power of two."""
        # While a chunked admission is in flight, decode stays single-tick
        # on purpose: the JAX package measured bursts there to lose
        # (they front-load decode into lower-occupancy ticks and stretch
        # the admission).
        if self.tick_batch < 2 or not self._per_row \
                or self._pending is not None:
            return 1
        if self.queue and self._free_slot() is not None:
            return 1  # an admission is possible right now: take it
        k = self.tick_batch
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            k = min(k, s.remaining, self.max_len - s.length - 1)
            if self.paged:
                # grant the burst's pages up front when the pool allows
                # (slots free every page at release or preemption, so an
                # early grant is never leaked); under pool pressure the
                # clamp below shortens the burst instead
                want = min(self.tick_batch, s.remaining,
                           self.max_len - s.length - 1)
                need_pg = self.allocator.pages_needed(s.length + want) \
                    - len(self._slot_pages[i])
                if need_pg > 0 and self.allocator.n_free >= need_pg:
                    for pg_id in self.allocator.alloc(need_pg):
                        self._add_page(i, pg_id)
                k = min(k, len(self._slot_pages[i])
                        * self.allocator.page_size - s.length)
        p2 = 1
        while p2 * 2 <= k:
            p2 *= 2
        return p2

    def _keep_mask(self) -> np.ndarray:
        """[B, W]: the positions of each row's penalty window."""
        window = self._last.shape[1]
        return (np.arange(window)[None, :]
                >= (window - self._row_window[:, None]))

    def _ctx_cap(self, k: int):
        """JAX's ``_cap_bucket`` for K dense ticks; paged ticks take none."""
        if self.paged:
            return None
        return ctx_cap_for(max(s.length for s in self.slots) + k,
                           self.max_len)

    def _lp_k(self) -> Optional[int]:
        """``logprobs_k`` when an active row wants logprobs (the tick then
        takes its logprobs variant), else None."""
        return self.logprobs_k if self._want_lp() else None

    def _tick_graph(self, k: int):
        """K replays of the captured tick; returns the [K, B] tokens and
        their logprobs (``_host_lp``; None without)."""
        gates = self._row_features()
        cap = self._ctx_cap(k)
        lp_k = self._lp_k()
        key = ("tick", tuple(sorted(gates.items())), cap, lp_k, cg.routes())

        def build():
            t = Tick(self, gates, cap, lp_k)
            return cg.Step(t.body, t)
        step = self.graphs.step(key, build)
        step.state.load(self)
        for _ in range(k):
            self.graphs.run(step)
        t = step.state
        lps = None if lp_k is None else _host_lp(t.lp[:k], t.top_i[:k],
                                                 t.top_lp[:k])
        return t.seq[:k].cpu().numpy(), lps

    def _decode_burst(self, k: int):
        """K decode+sample ticks issued back to back with no host sync; the
        [K, B] tokens (and logprobs) are fetched once, then emitted in
        order (a slot that stopped mid-burst discards its overshoot)."""
        active0 = [s.active for s in self.slots]
        if self.graphs is not None:
            seq, lps = self._tick_graph(k)
        else:
            seq, lps = self._eager_burst(k)
        for t in range(k):
            for i, slot in enumerate(self.slots):
                if active0[i] and slot.active:
                    slot.length += 1
                    self._emit(i, int(seq[t, i]),
                               *(() if lps is None else
                                 (lps[0][t, i], lps[1][t][i])))

    def _eager_burst(self, k: int):
        keep_mask = torch.as_tensor(self._keep_mask(), device=self.device)
        lengths = self._lengths()
        tables = self._table_tensor() if self.paged else None
        gates = self._row_features()
        cap = self._ctx_cap(k)
        toks = torch.as_tensor(self._next_tok, device=self.device)
        last = torch.as_tensor(self._last, device=self.device)
        lp_k = self._lp_k()
        seq, lps = [], []
        for _ in range(k):
            logits, _ = self._forward(
                self.params, self.cfg, toks[:, None], self._kv(), lengths,
                page_table=tables, ctx_cap=cap)
            tok, keys, mu = sampling.sample_rows(
                logits, self._keys, self._row_params, last, self._mu, **gates)
            self._keys.copy_(keys)
            self._mu.copy_(mu)
            if lp_k is not None:
                lps.append(_token_logprobs(logits, tok, lp_k))
            toks = tok.long()
            last = torch.where(
                keep_mask, torch.cat([last[:, 1:], toks[:, None]], 1), -1)
            lengths = lengths + 1
            seq.append(tok)
        seq = torch.stack(seq).cpu().numpy()                   # [K, B]
        if lp_k is None:
            return seq, None
        return seq, _host_lp(*(torch.stack(a) for a in zip(*lps)))

    def _decode_once(self):
        if self.paged:
            # grow: a slot writing at a page boundary needs a fresh page;
            # on exhaustion, preempt other slots until it fits
            p = self.allocator.page_size
            for i, slot in enumerate(self.slots):
                if not slot.active \
                        or slot.length != len(self._slot_pages[i]) * p:
                    continue
                while self.allocator.n_free < 1:
                    if self._pending is not None:
                        # cheapest victim: the in-flight admission (only
                        # prefill work is lost; its reservation frees)
                        self._cancel_admission()
                        continue
                    victim = max(
                        (j for j, s in enumerate(self.slots)
                         if s.active and j != i),
                        key=lambda j: len(self.slots[j].request.output_ids),
                        default=None)
                    if victim is None:
                        raise MemoryError(
                            "paged KV pool exhausted with one sequence")
                    self._preempt(victim)
                self._add_page(i, self.allocator.alloc(1)[0])
        if self._per_row and self.graphs is not None:
            seq, lps = self._tick_graph(1)
        else:
            seq, lps = self._eager_tick()
        for i, slot in enumerate(self.slots):
            if slot.active:
                slot.length += 1
                self._emit(i, int(seq[0, i]),
                           *(() if lps is None else
                             (lps[0][0, i], lps[1][0][i])))

    def _eager_tick(self):
        toks = torch.as_tensor(self._next_tok, device=self.device)
        last = torch.as_tensor(self._last, device=self.device)
        logits, _ = self._forward(
            self.params, self.cfg, toks[:, None], self._kv(), self._lengths(),
            page_table=self._table_tensor() if self.paged else None,
            ctx_cap=self._ctx_cap(1))
        if self._per_row:
            tok, keys, mu = sampling.sample_rows(
                logits, self._keys, self._row_params, last, self._mu,
                **self._row_features())
            self._keys.copy_(keys)
            self._mu.copy_(mu)
        else:
            tok, self._state = sampling.sample(logits, self._state,
                                               self.gcfg, last)
        lp_k = self._lp_k()
        lps = None if lp_k is None else _host_lp(
            *(a[None] for a in _token_logprobs(logits, tok, lp_k)))
        return tok.cpu().numpy()[None], lps

    def _cancel_admission(self):
        """Abort the in-flight chunked admission: requeue its request at
        the front of the queue and free the slot and its reserved pages."""
        slot_idx, _ = self._pending
        self._pending = None
        slot = self.slots[slot_idx]
        req = slot.request
        slot.request = None
        slot.admitting = False
        if self.paged:
            self.allocator.free(self._slot_pages[slot_idx])
            self._slot_pages[slot_idx] = []
        self.queue.appendleft(req)

    def _preempt(self, slot_idx: int):
        """Free a slot mid-generation and requeue its request with its
        emitted tokens folded into the prompt (recompute preemption): a
        later prefill of prompt + emitted rebuilds the cache, so nothing is
        emitted twice and greedy output is unchanged."""
        slot = self.slots[slot_idx]
        req = slot.request
        if req.input_embeds is not None and req.output_ids:
            # the emitted tokens are text: their table rows extend the
            # embeds (gathered on the device, only those rows)
            idx = torch.as_tensor(req.output_ids, device=self.device)
            rows = self.params.embed[idx].float().cpu().numpy()
            req.input_embeds = np.concatenate([req.input_embeds, rows])
        req.prompt_ids = np.concatenate(
            [req.prompt_ids, np.asarray(req.output_ids, np.int64)])
        slot.request = None
        slot.length = 0
        if self.paged:
            self._release_pages(slot_idx)
        self.queue.appendleft(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if not s.active:
                return i
        return None

    # -- admission ------------------------------------------------------------
    def _eligible_batch(self) -> list:
        """The largest power-of-two prefix (>= 2) of the queue head that can
        be admitted by one batched prefill: single-chunk prompts with no
        prefix-cache hit, at most one per free slot. FIFO order holds: the
        scan stops at the first prompt that does not fit."""
        if not self._batch_admit:
            return []
        cap = min(self.admission_chunk, self.max_len - 2)
        out = []
        free = sum(1 for s in self.slots if not s.active)
        for req in self.queue:
            if len(out) >= free or len(req.prompt_ids) > cap \
                    or req.input_embeds is not None:
                break
            if self._pfx_entries and \
                    self._prefix_match(req.prompt_ids) is not None:
                break  # a cached prefix beats a batched fresh prefill
            out.append(req)
        r = 1 << (len(out).bit_length() - 1) if out else 0
        return out[:r] if r >= 2 else []

    def _admit_batch(self, reqs: list):
        """Admit R queue-head requests at once: a ragged batched prefill
        (per-row true lengths) into an R-row scratch cache, R slot splices
        and R first-token samples. Per request this is the same math as
        the single path. It stores no prefix (as in the JAX package: the
        store copies scratch row 0 of a single admission)."""
        slots = []
        for req in reqs:
            self.queue.remove(req)
            slots.append(self._free_slot())
            self.slots[slots[-1]].request = req
        n_rows = len(reqs)
        self.tick_stats["batch_admits"] += 1
        self.tick_stats["batch_admit_reqs"] += n_rows

        rcfgs = [self._admit_host_prep(i, req) for i, req in zip(slots, reqs)]
        for i, rcfg in zip(slots, rcfgs):
            self._row_cfgs[i] = rcfg
        bucket = max(_bucket(len(r.prompt_ids)) for r in reqs)
        ids = np.zeros((n_rows, bucket), np.int64)
        true_lens = np.zeros((n_rows,), np.int64)
        for r, req in enumerate(reqs):
            ids[r, :len(req.prompt_ids)] = req.prompt_ids
            true_lens[r] = len(req.prompt_ids)

        scratch = self._multi_scratch.pop(n_rows, None)
        if scratch is None:
            scratch = kvc.init_cache(
                self.cfg.num_layers, n_rows,
                min(_bucket(self.admission_chunk), self.max_len),
                self.cfg.num_kv_heads, self.cfg.head_dim,
                quantized=self._scratch.quantized, device=self.device)
        scratch.length = 0
        logits, scratch = self._forward(
            self.params, self.cfg, torch.as_tensor(ids, device=self.device),
            scratch,
            torch.zeros((n_rows,), dtype=torch.int32, device=self.device),
            true_len=true_lens)
        _insert_multi(self.cache, scratch,
                      torch.as_tensor(slots, device=self.device), bucket)
        tok, lps = self._first_tokens(logits, slots, reqs, rcfgs)
        self._multi_scratch[n_rows] = scratch
        now = time.perf_counter()
        for r, (slot_idx, req) in enumerate(zip(slots, reqs)):
            req.first_token_t = now
            self._emit(slot_idx, int(tok[r]),
                       *(() if lps is None else (lps[0][0, r],
                                                 lps[1][0][r])))

    def _begin_admission(self, slot_idx: int, req: Request):
        """Reserve a slot (and, paged, the prefill's pages, up front: decode
        growth during a multi-tick prefill must not take them) and start
        the possibly chunked prefill."""
        n = len(req.prompt_ids)
        cap = self.max_len - 2
        if n > cap:
            req.prompt_ids = req.prompt_ids[-cap:]  # keep the tail
            if req.input_embeds is not None:
                req.input_embeds = req.input_embeds[-cap:]
            n = cap
        slot = self.slots[slot_idx]
        slot.request = req
        slot.admitting = True
        if self.paged:
            n_pg = self.allocator.pages_needed(min(_bucket(n), self.max_len))
            self._slot_pages[slot_idx] = self.allocator.alloc(n_pg)
        self._scratch.length = 0
        done0 = 0
        # a multimodal prompt bypasses the prefix cache: its ids hold 0 at
        # the image's positions, so its KV is not a function of its ids
        if self._pfx_entries and req.input_embeds is None:
            hit = self._prefix_match(req.prompt_ids)
            if hit is not None:
                entry, m = hit
                _prefix_load(self._scratch, self._pfx_store, entry, m)
                done0 = m
                self.prefix_stats["hits"] += 1
                self.prefix_stats["hit_tokens"] += m
        self._pending = [slot_idx, done0]
        self._admit_chunk()

    def _admit_chunk(self):
        """Prefill ONE chunk of the pending admission; the last chunk also
        finishes the admission (splice and first token)."""
        slot_idx, done = self._pending
        self.tick_stats["admit_chunks"] += 1
        req = self.slots[slot_idx].request
        n = len(req.prompt_ids)
        take = min(self.admission_chunk, n - done)
        if done + take >= n:
            self._pending = None
            self._finish_admission(slot_idx, req, done, take)
            return
        self._prefill_engine.prefill(req.prompt_ids[None, done:done + take],
                                     self._scratch, start=done,
                                     input_embeds=_chunk(req, done, take))
        self._pending[1] = done + take

    def _admit_host_prep(self, slot_idx: int, req: Request):
        """Host-side bookkeeping of an admission: slot budget, penalty
        window, the row's config. Returns that config."""
        n = len(req.prompt_ids)
        slot = self.slots[slot_idx]
        slot.admitting = False  # the slot joins the decode batch this tick
        slot.length = n
        # resumed (preempted) requests keep their budget: n_predict counts
        # all emitted tokens, of which len(output_ids) already happened
        slot.remaining = min(req.n_predict - len(req.output_ids),
                             self.max_len - n - 1)
        window = self._last.shape[1]
        self._last[slot_idx] = -1
        tail = min(window, n)
        self._last[slot_idx, window - tail:] = req.prompt_ids[n - tail:]
        rcfg = req.gcfg or self.gcfg
        self._row_window[slot_idx] = min(
            max(self._resolve_window(rcfg), 0), window)
        self._mask_row_window(slot_idx)
        # speculation keeps greedy exact only for a pure argmax chain (the
        # verify drops penalties and bias)
        self._row_greedy[slot_idx] = (
            rcfg.temp <= 0 and rcfg.repeat_penalty == 1.0
            and rcfg.frequency_penalty == 0.0
            and rcfg.presence_penalty == 0.0 and rcfg.mirostat == 0
            and not rcfg.logit_bias)
        if self.speculative:
            self._hist_dirty[slot_idx] = True
        return rcfg

    def _row_key_for(self, req: Request, rcfg: GenerationConfig) -> list:
        """(key, step 0) of a request's random stream: its own seed, or the
        engine seed and its request id."""
        if req.gcfg is not None and rcfg.seed >= 0:
            return [sampling.row_key(rcfg.seed), 0]
        return [sampling.row_key(max(self.gcfg.seed, 0),
                                 req.request_id + 1 + len(self.slots)), 0]

    def _finish_admission(self, slot_idx: int, req: Request, done: int,
                          take: int):
        """The last prefill chunk, the scratch → slot (or pages) splice, the
        row's sampler state and the first token, in one function."""
        n = len(req.prompt_ids)
        logits, _ = self._prefill_engine.prefill(
            req.prompt_ids[None, done:done + take], self._scratch, start=done,
            input_embeds=_chunk(req, done, take))
        rcfg = self._admit_host_prep(slot_idx, req)
        self._row_cfgs[slot_idx] = rcfg
        insert_bucket = min(_bucket(n), self.max_len)
        if self.paged:
            pages = self._slot_pages[slot_idx]  # reserved at the start
            if len(pages) != self.allocator.pages_needed(insert_bucket):
                raise RuntimeError(f"slot {slot_idx} holds {len(pages)} "
                                   f"pages for a {insert_bucket} bucket")
            self._tables[slot_idx] = self._dead_page
            self._tables[slot_idx, :len(pages)] = pages
            _insert_pages(self.page_cache, self._scratch,
                          torch.as_tensor(pages, device=self.device),
                          len(pages) * self.allocator.page_size)
        else:
            _insert_slot(self.cache, self._scratch, slot_idx, insert_bucket)
        tok, lps = self._first_tokens(logits, [slot_idx], [req], [rcfg])
        req.first_token_t = time.perf_counter()
        if self._pfx_entries:
            self._maybe_store_prefix(req)
        self._emit(slot_idx, int(tok[0]),
                   *(() if lps is None else (lps[0][0, 0], lps[1][0][0])))

    # -- prefix cache ---------------------------------------------------------
    def _prefix_match(self, prompt: np.ndarray):
        """Longest common token prefix against the stored entries, capped
        at n - 1 so the last chunk prefills >= 1 token and gives the first
        token's logits. Returns (entry, m) or None; refreshes the LRU."""
        n = len(prompt)
        best, best_m = None, 0
        for e, toks in enumerate(self._pfx_tokens):
            if toks is None:
                continue
            k = min(len(toks), n)
            neq = np.nonzero(toks[:k] != prompt[:k])[0]
            m = int(neq[0]) if len(neq) else k
            if m > best_m:
                best, best_m = e, m
        best_m = min(best_m, n - 1)
        if best is None or best_m < self._prefix_min:
            return None
        self._pfx_lru.remove(best)
        self._pfx_lru.append(best)
        return best, best_m

    def _maybe_store_prefix(self, req: Request):
        """After an admission, store the prompt's KV head (up to the pool
        width) unless an entry already covers it; evicts the LRU entry."""
        if req.input_embeds is not None:
            return  # an image's KV is not a function of the 0-filled ids
        w = self._pfx_store.max_len
        keep = min(len(req.prompt_ids), w)
        if keep < self._prefix_min:
            return
        head = req.prompt_ids[:keep]
        for toks in self._pfx_tokens:
            if toks is not None and len(toks) >= keep and \
                    np.array_equal(toks[:keep], head):
                return  # already covered by a same-or-longer entry
        victim = self._pfx_lru.pop(0)
        self._pfx_lru.append(victim)
        _prefix_store(self._pfx_store, self._scratch, victim)
        self._pfx_tokens[victim] = head.copy()
        self.prefix_stats["stores"] += 1

    def _first_tokens(self, logits, slots: list, reqs, rcfgs):
        """Set the admitted rows' sampler state (params, key, mu) and draw
        their first tokens from the prefill logits [R, V]. Returns the
        tokens on the host and, when an admitted request wants them, their
        logprobs (``_host_lp`` over one tick; else None)."""
        idx = torch.as_tensor(slots, device=self.device)
        last = torch.as_tensor(self._last[slots], device=self.device)
        mu0 = torch.tensor([2.0 * c.mirostat_tau for c in rcfgs],
                           dtype=torch.float32, device=self.device)
        if not self._per_row:
            state = sampling.SamplerState(gen=self._state.gen, mu=mu0)
            tok, state = sampling.sample(logits, state, self.gcfg, last)
            self._state.mu[idx] = state.mu
        else:
            rp = sampling.RowParams.from_configs(rcfgs, self.device)
            keys = torch.tensor([self._row_key_for(r, c)
                                 for r, c in zip(reqs, rcfgs)],
                                dtype=torch.int64, device=self.device)
            tok, keys, mu = sampling.sample_rows(logits, keys, rp, last, mu0,
                                                 **_features(rcfgs))
            self._row_params.set_rows(idx, rp)
            self._keys[idx] = keys
            self._mu[idx] = mu
        lps = None
        if any(r.logprobs is not None for r in reqs):
            lps = _host_lp(*(a[None] for a in _token_logprobs(
                logits, tok, self.logprobs_k)))
        return tok.cpu().numpy(), lps

    # -- per-tick helpers -----------------------------------------------------
    def _kv(self):
        return self.page_cache if self.paged else self.cache

    def _lengths(self) -> torch.Tensor:
        """Per-slot lengths as one int32 [B] tensor on the device, built
        once per tick."""
        return torch.tensor([s.length for s in self.slots], dtype=torch.int32,
                            device=self.device)

    def _table_tensor(self) -> torch.Tensor:
        return torch.as_tensor(self._tables, device=self.device)

    def _add_page(self, slot_idx: int, pg_id: int):
        self._slot_pages[slot_idx].append(pg_id)
        self._tables[slot_idx, len(self._slot_pages[slot_idx]) - 1] = pg_id

    def _release_pages(self, slot_idx: int):
        """Recycle every page of a slot; its row points at the dead page."""
        self.allocator.free(self._slot_pages[slot_idx])
        self._slot_pages[slot_idx] = []
        self._tables[slot_idx] = self._dead_page

    def _row_features(self) -> dict:
        """Sampler stage gates over the ACTIVE rows (``_features``);
        inactive rows' draws are discarded, so their stale configs cannot
        affect emitted tokens."""
        return _features([self._row_cfgs[i] for i, s in enumerate(self.slots)
                          if s.active])

    def _want_lp(self) -> bool:
        """Any active slot wants logprobs: the tick computes them for the
        whole batch, and ``_emit`` keeps those of the rows that asked."""
        return any(s.active and s.request.logprobs is not None
                   for s in self.slots)

    def _mask_row_window(self, slot_idx: int):
        """Per-request repeat_last_n: blank history older than the row's
        window (the shared history is sized by the engine gcfg; a request
        asking for a larger window is capped at it)."""
        w = int(self._row_window[slot_idx])
        full = self._last.shape[1]
        if w < full:
            self._last[slot_idx, :full - w] = -1

    def _emit(self, slot_idx: int, token: int, lp=None, top=None):
        """Record a sampled token for a slot; finish and free the slot on a
        stop token or at its length budget. lp, top: the token's logprob
        and the [(id, logprob)] alternatives of its tick, kept when the
        request asked for them."""
        slot = self.slots[slot_idx]
        req = slot.request
        req.output_ids.append(token)
        if req.logprobs is not None and lp is not None:
            req.output_logprobs.append(float(lp))
            req.output_top_logprobs.append(
                [] if not req.logprobs else top[:req.logprobs])
        if self.speculative and not self._in_spec:
            self._hist_dirty[slot_idx] = True  # the device history is stale
        if req.on_token is not None:
            req.on_token(token, req)
        self._next_tok[slot_idx] = token
        self._last[slot_idx] = np.roll(self._last[slot_idx], -1)
        self._last[slot_idx, -1] = token
        self._mask_row_window(slot_idx)
        slot.remaining -= 1

        if token in req.stop_token_ids:
            req.finish_reason = "stop"
        elif slot.remaining <= 0 or slot.length + 1 >= self.max_len:
            req.finish_reason = "length"
        else:
            return
        req.finished = True
        req.done_t = time.perf_counter()
        self.done.append(req)
        slot.request = None
        slot.length = 0  # frozen; dead-row writes land at position 0
        if self.paged:
            self._release_pages(slot_idx)


class Tick:
    """The serving decode tick over static buffers (JAX ``_decode_multi``'s
    scan body): the forward at per-row ``lengths`` (dense with
    ``ctx_cap``, or through the page table), ``sample_rows`` with the
    server's row keys, params and mu (updated in place), the token written
    at row ``tick`` of ``seq``, the penalty window moved under ``keep``,
    lengths + 1. ``gates``: ``sample_rows``' static stage gates. With
    ``lp_k`` (the logprobs variant) each tick also writes the tokens'
    logprobs and top ``lp_k`` alternatives at row ``tick`` of ``lp``,
    ``top_i`` and ``top_lp``, buffers made outside the capture. ``body``
    is what the card captures; it runs eagerly anywhere (the CPU tests).
    It holds the server's model and per-row state, not the server (no
    reference cycle through the server's graphs)."""

    def __init__(self, srv: "ServingEngine", gates: dict, ctx_cap,
                 lp_k: Optional[int] = None):
        dev, b = srv.device, srv.n_slots
        w = srv._last.shape[1]
        self.gates, self.ctx_cap = dict(gates), ctx_cap
        self.model = (srv._forward, srv.params, srv.cfg, srv._kv())
        self.rows = (srv._keys, srv._row_params, srv._mu)
        self.toks = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.last = torch.full((b, w), -1, dtype=torch.int64, device=dev)
        self.keep = torch.zeros((b, w), dtype=torch.bool, device=dev)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.tables = (torch.zeros((b, srv.max_pages), dtype=torch.int32,
                                   device=dev) if srv.paged else None)
        self.seq = torch.zeros((srv.tick_batch, b), dtype=torch.int32,
                               device=dev)
        self.tick = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.lp_k = lp_k
        if lp_k is not None:
            n = srv.tick_batch
            self.lp = torch.zeros((n, b), dtype=torch.float32, device=dev)
            self.top_i = torch.zeros((n, b, lp_k), dtype=torch.int64,
                                     device=dev)
            self.top_lp = torch.zeros((n, b, lp_k), dtype=torch.float32,
                                      device=dev)

    def load(self, srv: "ServingEngine") -> None:
        """A burst's start: the host's next tokens, windows, lengths and
        page table into the static buffers."""
        self.toks.copy_(torch.from_numpy(srv._next_tok))
        self.last.copy_(torch.from_numpy(srv._last))
        self.keep.copy_(torch.from_numpy(srv._keep_mask()))
        self.lengths.copy_(torch.tensor([s.length for s in srv.slots],
                                        dtype=torch.int32))
        if self.tables is not None:
            self.tables.copy_(torch.from_numpy(srv._tables))
        self.tick.zero_()

    def body(self) -> None:
        forward, params, cfg, kv = self.model
        keys0, row_params, mu0 = self.rows
        logits, _ = forward(params, cfg, self.toks[:, None], kv,
                            self.lengths, page_table=self.tables,
                            ctx_cap=self.ctx_cap)
        tok, keys, mu = sampling.sample_rows(
            logits, keys0, row_params, self.last, mu0, **self.gates)
        keys0.copy_(keys)
        if mu is not mu0:
            mu0.copy_(mu)
        self.seq.index_copy_(0, self.tick, tok[None])
        if self.lp_k is not None:
            lp, ti, tl = _token_logprobs(logits, tok, self.lp_k)
            self.lp.index_copy_(0, self.tick, lp[None])
            self.top_i.index_copy_(0, self.tick, ti[None])
            self.top_lp.index_copy_(0, self.tick, tl[None])
        self.tick.add_(1)
        self.toks.copy_(tok)
        self.last.copy_(torch.where(
            self.keep, torch.cat([self.last[:, 1:], self.toks[:, None]], 1),
            -1))
        self.lengths.add_(1)


class SpecTick:
    """The speculative tick over static buffers (JAX ``_spec_verify``):
    ``speculative.verify`` of every slot's next token ``last`` at its
    ``lengths`` with its device history (the server's ``_hist``, updated in
    place) and valid count ``h``; the argmax tokens go to ``seq``
    [B, K+1] and each row's emitted count to ``emitted`` [B]. ``body`` is
    what the card captures; it runs eagerly anywhere."""

    def __init__(self, srv: "ServingEngine"):
        dev, b = srv.device, srv.n_slots
        self.model = (srv._forward, srv.params, srv.cfg, srv.cache)
        self.hist, self.K = srv._hist, srv.spec_K
        self.last = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.h = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.seq = torch.zeros((b, self.K + 1), dtype=torch.int64, device=dev)
        self.emitted = torch.zeros((b,), dtype=torch.int64, device=dev)

    def load(self, srv: "ServingEngine") -> None:
        self.last.copy_(torch.from_numpy(srv._next_tok))
        self.lengths.copy_(torch.tensor([s.length for s in srv.slots],
                                        dtype=torch.int32))
        self.h.copy_(torch.from_numpy(srv._h))

    def body(self) -> None:
        forward, params, cfg, cache = self.model
        g, emitted = spec.verify(forward, params, cfg, self.last, cache,
                                 self.lengths, self.hist, self.h, self.K)
        self.seq.copy_(g)
        self.emitted.copy_(emitted)


def _token_logprobs(logits: torch.Tensor, tok: torch.Tensor, lp_k: int):
    """The chosen tokens' logprobs [B] under the raw model logits [B, V]
    (before any sampling stage, so a greedy and a sampled request over one
    prefix report the same numbers) and, when lp_k > 0, the top lp_k ids
    and logprobs [B, lp_k], ties ordered as ``lax.top_k`` orders them
    (value descending, then index ascending: a stable descending sort)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    lp = lg.gather(1, tok.long()[:, None])[:, 0] - lse
    if lp_k > 0:
        vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
        return lp, idx[:, :lp_k], vals[:, :lp_k] - lse[:, None]
    b = lg.shape[0]
    return (lp, torch.zeros((b, 0), dtype=torch.int64, device=lg.device),
            torch.zeros((b, 0), dtype=torch.float32, device=lg.device))


def _host_lp(lp: torch.Tensor, top_i: torch.Tensor, top_lp: torch.Tensor):
    """[K, B] logprobs and [K, B, k] tops on the device → (lp [K, B] numpy,
    [K][B] lists of (id, logprob) pairs), JAX's ``_zip_tops``."""
    return lp.cpu().numpy(), _zip_tops(top_i.cpu().numpy(),
                                       top_lp.cpu().numpy())


def _zip_tops(top_i: np.ndarray, top_lp: np.ndarray) -> list:
    """[K, B, k] id and logprob arrays → [K][B] lists of (id, logprob)."""
    return [[list(zip(ti.tolist(), tl.tolist()))
             for ti, tl in zip(top_i[t], top_lp[t])]
            for t in range(top_i.shape[0])]


def _chunk(req: Request, done: int, take: int):
    """A multimodal request's embeds for prompt positions
    [done, done + take) as [1, take, E], or None for a text request."""
    if req.input_embeds is None:
        return None
    return req.input_embeds[None, done:done + take]


_KMAX_BUCKETS = (8, 64, 256, 1024)


def _kmax_bucket(kmax: int) -> int:
    """A batch's largest top_k rounded up to a fixed bucket (rows keep their
    own k: sample_rows clips each row's k and masks beyond it). Above the
    largest bucket: 0, the full-vocabulary sorted path."""
    if kmax <= 0:
        return 0
    for b in _KMAX_BUCKETS:
        if kmax <= b:
            return b
    return 0


def _features(cfgs) -> dict:
    """``sample_rows``' stage gates for the rows with configs ``cfgs``:
    each stage runs only if some row uses it (an unused stage is the
    identity but costs full-vocabulary sorts and softmaxes)."""
    ks = [c.top_k for c in cfgs]
    return dict(
        use_bias=any(bool(c.logit_bias) for c in cfgs),
        use_tfs_typical=any(c.tfs_z < 1.0 or c.typical_p < 1.0 for c in cfgs),
        use_mirostat=any(c.mirostat != 0 for c in cfgs),
        top_k_max=_kmax_bucket(max(ks) if ks and min(ks) > 0 else 0),
        # every row's penalties lower logits only: the candidate-domain
        # sampler is exact
        pen_lower=all(c.repeat_penalty >= 1.0 and c.frequency_penalty >= 0.0
                      and c.presence_penalty >= 0.0 for c in cfgs))


def _kv_leaves(cache, scratch):
    """(destination, source) pairs of a cache and a scratch cache: k, v
    and, with int8 storage, their scales."""
    pairs = [(cache.k, scratch.k), (cache.v, scratch.v)]
    if cache.k_scale is not None:
        pairs += [(cache.k_scale, scratch.k_scale),
                  (cache.v_scale, scratch.v_scale)]
    return pairs


def _insert_slot(cache: kvc.KVCache, scratch: kvc.KVCache, slot_idx: int,
                 bucket: int):
    """Splice scratch[:, 0, :, :bucket] into cache[:, slot_idx] (in place;
    bucket is the prefill bucket, positions past the prompt are garbage
    beyond the slot's length)."""
    for dst, src in _kv_leaves(cache, scratch):
        dst[:, slot_idx, :, :bucket] = src[:, 0, :, :bucket]


def _insert_multi(cache: kvc.KVCache, scratch: kvc.KVCache,
                  slot_idxs: torch.Tensor, bucket: int):
    """Splice scratch rows 0..R-1 into cache slots slot_idxs[r] (one
    indexed assignment per buffer)."""
    r = slot_idxs.shape[0]
    for dst, src in _kv_leaves(cache, scratch):
        dst[:, slot_idxs, :, :bucket] = src[:, :r, :, :bucket]


def _insert_pages(page_cache: pg.PagedKVCache, scratch: kvc.KVCache,
                  page_ids: torch.Tensor, bucket: int):
    """Splice a single-request prefill (scratch row 0, a page-aligned span
    of ``bucket`` positions) into its allocated pages."""
    sks = svs = None
    if scratch.quantized:
        sks = scratch.k_scale[:, 0, :, :bucket]
        svs = scratch.v_scale[:, 0, :, :bucket]
    pg.insert_prefix(page_cache, scratch.k[:, 0, :, :bucket],
                     scratch.v[:, 0, :, :bucket], page_ids, sks, svs)


def _prefix_load(scratch: kvc.KVCache, store: kvc.KVCache, entry: int,
                 m: int):
    """Copy prefix-cache entry ``entry`` into the prefill scratch's row 0
    (in place) and set its length to ``m``. The whole entry width is
    copied: positions in [m, n) are rewritten by the tail's prefill and
    positions >= n lie past the admitted length, never attended."""
    w = store.max_len
    for dst, src in _kv_leaves(scratch, store):
        dst[:, 0, :, :w] = src[:, entry]
    scratch.length = m


def _prefix_store(store: kvc.KVCache, scratch: kvc.KVCache, entry: int):
    """Copy the scratch's row 0, its first entry-width positions, into
    entry ``entry`` (in place). Positions past the prompt hold garbage:
    the host-side token record never matches past the prompt."""
    w = store.max_len
    for dst, src in _kv_leaves(store, scratch):
        dst[:, entry] = src[:, 0, :, :w]
