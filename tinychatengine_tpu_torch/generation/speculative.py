"""Prompt-lookup (self-speculative) greedy decoding (counterpart of the JAX
package's ``generation/speculative.py``).

Draft tokens come from the sequence itself: the continuation of the most
recent earlier occurrence of the current bigram. One forward over the last
token and the K drafts ([B, K+1] tokens, all logits) verifies them; a row
accepts its longest draft prefix that equals the argmax chain and emits
that many tokens plus one. With greedy sampling and no penalties the
tokens are those of plain greedy decoding, up to the rounding of a K+1-row
forward against a one-row one (the card computes them through other
kernels: ``flash_prefill`` and the matmuls at more rows).

Draft K/V written past the accepted length need no rollback: every reader
masks positions past a row's length, and later steps overwrite them.

The JAX package runs the loop as one ``while_loop`` whose trip count
depends on the data. Here each verify step is one captured CUDA graph on
the card (``generation/cuda_graph.py``), replayed once a step, and the
host reads that step's emitted count to decide whether to go on; on the
CPU, or with ``Engine(cuda_graphs=False)``, the step runs eagerly.
``runtime/serving.py`` runs the same ``verify`` over its slots.
"""

from __future__ import annotations

import numpy as np
import torch

from tinychatengine_tpu_torch.generation import cuda_graph as cg
from tinychatengine_tpu_torch.generation import kv_cache as kvc


def _lookup_draft(hist: torch.Tensor, h: torch.Tensor, prev_tok: torch.Tensor,
                  last_tok: torch.Tensor, K: int):
    """Per row b, the largest i < h[b] - 1 with hist[b, i - 1] == prev_tok[b]
    and hist[b, i] == last_tok[b]; the draft is hist[b, i + 1 : i + 1 + K]
    (the history's first K entries appended past its end), or its first K
    entries when no i matches.

    hist [B, T] int (entries at h and beyond are stale); h, prev_tok,
    last_tok [B]. Returns (draft [B, K] int64, found [B] bool)."""
    b, t = hist.shape
    dev = hist.device
    idx = torch.arange(t, device=dev)
    prev_h = torch.cat([torch.full((b, 1), -1, dtype=hist.dtype, device=dev),
                        hist[:, :-1]], dim=1)
    match = ((hist == last_tok[:, None]) & (prev_h == prev_tok[:, None])
             & (idx[None, :] < (h - 1)[:, None]) & (idx[None, :] >= 1))
    i = torch.where(match, idx[None, :], -1).amax(dim=1)
    found = i >= 0
    start = torch.where(found, i + 1, 0).clamp(max=t)
    ext = torch.cat([hist, hist[:, :K]], dim=1)
    draft = ext.gather(1, start[:, None] + torch.arange(K, device=dev))
    return draft.long(), found


def verify(forward_fn, params, cfg, last_tok: torch.Tensor, cache,
           starts: torch.Tensor, hist: torch.Tensor, h: torch.Tensor, K: int):
    """One batched draft-and-verify step: each row drafts K tokens from its
    history (``_lookup_draft``, the bigram of hist[h - 2] and
    ``last_tok``), one forward runs every row's [last, draft] at its own
    position ``starts`` (int32 [B] on the device) with all logits, and row
    b accepts a[b] drafts: emitted[b] = a[b] + 1 argmax tokens, the first
    emitted[b] of g[b]. The K + 1 argmax tokens are written into ``hist``
    at h (in place; the write start clamped so it fits, as JAX's
    ``dynamic_update_slice`` clamps it). The cache holds K/V at
    starts..starts+K; only starts + emitted are valid after.
    Returns (g [B, K+1] int64, emitted [B] int64)."""
    b, t = hist.shape
    dev = hist.device
    rows = torch.arange(b, device=dev)
    prev = hist[rows, (h - 2).clamp(0, t - 1)]
    draft, _ = _lookup_draft(hist, h, prev, last_tok, K)
    tokens_in = torch.cat([last_tok[:, None].long(), draft], dim=1)
    logits, _ = forward_fn(params, cfg, tokens_in, cache, starts,
                           full_logits=True)               # [B, K+1, V]
    g = logits.argmax(dim=-1)                              # [B, K+1]
    a = (draft == g[:, :K]).long().cumprod(dim=1).sum(dim=1)
    at = h.clamp(max=t - K - 1)[:, None] + torch.arange(K + 1, device=dev)
    hist.scatter_(1, at, g.to(hist.dtype))
    return g, a + 1


class PLDStep:
    """``generate_pld``'s verify step over static buffers (batch 1): the
    history ``hist`` [1, T] and its valid count ``h``, the last emitted
    token, the cache position ``pos`` (int32 [1]) and ``n_out``, the tokens
    emitted since the first. ``body`` runs ``verify`` and advances them;
    it is what the card captures, and runs eagerly anywhere."""

    def __init__(self, eng, cache, K: int, hist_len: int):
        dev = eng.device
        self.model = (eng._forward, eng.params, eng.cfg)
        self.cache, self.K = cache, K
        self.hist = torch.zeros((1, hist_len), dtype=torch.int64, device=dev)
        self.h = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.last = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.n_out = torch.zeros((1,), dtype=torch.int64, device=dev)

    def reset(self, hist: np.ndarray, h: int, pos: int) -> None:
        self.hist.copy_(torch.from_numpy(hist)[None])
        self.h.fill_(h)
        self.last.fill_(int(hist[h - 1]))
        self.pos.fill_(pos)
        self.n_out.zero_()

    def body(self) -> None:
        forward, params, cfg = self.model
        g, emitted = verify(forward, params, cfg, self.last, self.cache,
                            self.pos, self.hist, self.h, self.K)
        self.last.copy_(g.gather(1, (emitted - 1)[:, None])[:, 0])
        self.h.add_(emitted)
        self.pos.add_(emitted.to(torch.int32))
        self.n_out.add_(emitted)


@torch.inference_mode()
def generate_pld(engine, input_ids, n_tokens: int, K: int = 7, cache=None,
                 start: int = 0):
    """Greedy prompt-lookup generation through an ``Engine`` (batch 1).

    cache/start: continue a conversation (the lookup history holds only
    this call's tokens). Returns (tokens [n_tokens] int numpy, forward
    steps including the prefill, cache); the cache then holds exactly
    positions [0, start + n_prompt + n_tokens). The loop stops early only
    where a verify would pass the cache's end (JAX's bound), leaving zeros.

    On the card the prefill and the verify step replay captured graphs in
    the engine's own cache (the caller's positions [0, start) copied in,
    the call's copied back out), one replay a step and one host read of
    the step's emitted count after it."""
    input_ids = np.atleast_2d(np.asarray(input_ids, np.int64))
    if input_ids.shape[0] != 1:
        raise ValueError("speculative decoding is batch-1")
    n_prompt = input_ids.shape[1]
    if cache is None:
        cache = engine.new_cache()
    run = cache
    if engine.graphs is not None:
        run = engine._own_cache(cache)
        kvc.copy_positions(cache, run, 0, start)
    run.length = start
    logits, _ = engine._prefill(input_ids, run, start)
    first = int(logits.argmax(dim=-1)[0])

    hist_len = run.max_len + K + 1
    hist = np.zeros((hist_len,), np.int64)
    hist[:n_prompt] = input_ids[0]
    hist[n_prompt] = first
    pos0 = start + n_prompt
    if engine.graphs is not None:
        key = ("pld", cg.storage_key(run.k, run.v, run.k_scale), K, hist_len,
               cg.routes())

        def build():
            st = PLDStep(engine, run, K, hist_len)
            return cg.Step(st.body, st)
        step = engine.graphs.step(key, build)
        state, advance = step.state, lambda: engine.graphs.run(step)
    else:
        state = PLDStep(engine, run, K, hist_len)
        advance = state.body
    state.reset(hist, n_prompt + 1, pos0)
    n_out = steps = 0
    while n_out < n_tokens - 1 and pos0 + n_out + K + 1 < run.max_len:
        advance()
        steps += 1
        n_out = int(state.n_out.item())    # the step's emitted count
    got = state.hist[0, n_prompt + 1:n_prompt + 1 + min(n_out, n_tokens - 1)]
    tokens = np.zeros((n_tokens,), np.int64)
    tokens[0] = first
    tokens[1:1 + got.shape[0]] = got.cpu().numpy()

    # The cache must end at exactly start + n_prompt + n_tokens positions.
    # A token's K/V is written when it is fed, so the last emitted token's
    # is missing unless the last verify overshot; past an overshoot the
    # rows hold speculative K/V. Feed the unfed last token (its logits
    # unused), or cut the length back.
    n_emitted = 1 + n_out
    if n_emitted <= n_tokens:
        run.length = pos0 + n_emitted - 1
        tail = torch.as_tensor([[int(tokens[n_emitted - 1])]],
                               device=engine.device)
        engine._forward(engine.params, engine.cfg, tail, run, run.length)
    else:
        run.length = pos0 + n_tokens
    if run is not cache:
        kvc.copy_positions(run, cache, start, run.length)
        cache.length = run.length
    return tokens, steps + 1, cache
