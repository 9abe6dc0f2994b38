"""Sampling on the device (counterpart of the JAX package's
``generation/sampling.py``: ``sample`` and what it calls).

Logits [B, V] stay on the device; every truncation filter is a mask to
-1e30, and the draw is Gumbel-max with noise from a ``torch.Generator``
(a different stream from JAX's PRNG for the same seed). The llama.cpp
semantics of the reference's ``sample_*`` functions are kept:

- repetition penalty: penalized logit > 0 → /penalty, else *penalty
- frequency/presence: logit -= count*alpha_freq + (count>0)*alpha_pres
- greedy, temperature, top-k, top-p, tail-free, typical
- mirostat v1 / v2 with carried mu
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tinychatengine_tpu_torch.core.device import resolve_device
from tinychatengine_tpu_torch.ops.ref import xla_recip

NEG_INF = -1e30
# the factor of JAX's ``/ jnp.log(2.0)`` under jit (f32 ln 2, then its f32
# reciprocal): surprise in bits
_RECIP_LN2 = xla_recip(np.log(np.float32(2.0)))


def _token_counts(last_tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """Occurrences per vocab id of a [B, T] window (-1 entries ignored)
    → [B, V] f32."""
    valid = (last_tokens >= 0).float()
    counts = torch.zeros((last_tokens.shape[0], vocab), dtype=torch.float32,
                         device=last_tokens.device)
    return counts.scatter_add_(1, last_tokens.clamp(0, vocab - 1).long(),
                               valid)


def apply_repetition_penalty(logits, last_tokens, penalty: float):
    if penalty == 1.0:
        return logits
    hit = _token_counts(last_tokens, logits.shape[-1]) > 0
    penalized = torch.where(logits > 0, logits * xla_recip(penalty),
                            logits * penalty)
    return torch.where(hit, penalized, logits)


def apply_frequency_presence(logits, last_tokens, alpha_freq: float,
                             alpha_pres: float):
    if alpha_freq == 0.0 and alpha_pres == 0.0:
        return logits
    counts = _token_counts(last_tokens, logits.shape[-1])
    return logits - counts * alpha_freq - (counts > 0).float() * alpha_pres


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def greedy_penalized(logits, last_tokens, gcfg) -> torch.Tensor:
    """Greedy with penalties. With lowering-only penalties (repeat_penalty
    >= 1, non-negative alphas) the penalized argmax lies among the raw top
    1 + T logits, so penalties are applied in that candidate domain. Ties
    at the penalized maximum go to the candidate that ``lax.top_k``'s stable
    order puts first (higher raw logit, then lower vocab id), as in the JAX
    version."""
    no_pen = (gcfg.repeat_penalty == 1.0 and gcfg.frequency_penalty == 0.0
              and gcfg.presence_penalty == 0.0)
    if last_tokens is None or no_pen:
        return greedy(logits)
    if gcfg.repeat_penalty < 1.0 or gcfg.frequency_penalty < 0.0 \
            or gcfg.presence_penalty < 0.0:
        lp = apply_repetition_penalty(logits, last_tokens, gcfg.repeat_penalty)
        lp = apply_frequency_presence(lp, last_tokens, gcfg.frequency_penalty,
                                      gcfg.presence_penalty)
        return greedy(lp)
    v = logits.shape[-1]
    c = min(1 + last_tokens.shape[1], v)
    raw, cidx = torch.topk(logits, c, dim=-1)
    cnt = ((cidx[:, :, None] == last_tokens[:, None, :])
           & (last_tokens[:, None, :] >= 0)).sum(-1).float()
    pen = torch.where(raw > 0, raw * xla_recip(gcfg.repeat_penalty),
                      raw * gcfg.repeat_penalty)
    cvals = torch.where(cnt > 0, pen, raw)
    cvals = (cvals - cnt * gcfg.frequency_penalty
             - (cnt > 0).float() * gcfg.presence_penalty)
    # first maximum in (raw value descending, id ascending) order
    best = cvals == cvals.amax(dim=-1, keepdim=True)
    top_raw = torch.where(best, raw, NEG_INF).amax(dim=-1, keepdim=True)
    best = best & (raw == top_raw)
    return torch.where(best, cidx, v).amin(dim=-1).to(torch.int32)


def apply_temperature(logits, temp: float):
    return logits * xla_recip(max(temp, 1e-6))


def surprise_bits(log_probs: torch.Tensor) -> torch.Tensor:
    """-log_probs in bits: JAX's ``-log_probs / jnp.log(2.0)`` as jitted
    JAX runs it (a product by the f32 reciprocal of f32 ln 2)."""
    return -log_probs * _RECIP_LN2


def top_k_mask(logits, k: int):
    """Keep the k highest logits."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _sorted_desc(logits):
    return torch.sort(logits, dim=-1, descending=True).values


def _threshold_mask(logits, sorted_logits, keep_sorted):
    n_keep = keep_sorted.sum(-1, keepdim=True)
    thresh = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits < thresh, NEG_INF, logits)


def top_p_mask(logits, p: float, min_keep: int = 1):
    """Nucleus: keep sorted entries until the cumulative prob passes p."""
    if p >= 1.0:
        return logits
    sl = _sorted_desc(logits)
    probs = torch.softmax(sl, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    keep[..., :min_keep] = True
    return _threshold_mask(logits, sl, keep)


def tail_free_mask(logits, z: float, min_keep: int = 1):
    """Tail-free: drop the tail where the normalized |second derivative|
    of the sorted probs accumulates past z (over the live tokens only)."""
    if z >= 1.0:
        return logits
    v = logits.shape[-1]
    sl = _sorted_desc(logits)
    probs = torch.softmax(sl, dim=-1)
    d1 = probs[..., :-1] - probs[..., 1:]
    d2 = (d1[..., :-1] - d1[..., 1:]).abs()
    n_live = (sl > NEG_INF / 2).sum(-1, keepdim=True)
    d2 = torch.where(torch.arange(v - 2, device=logits.device)[None, :]
                     < n_live - 2, d2, 0.0)
    d2 = d2 / torch.clamp(d2.sum(-1, keepdim=True), min=1e-12)
    cum = torch.cumsum(d2, dim=-1)
    ones = torch.ones_like(cum[..., :1], dtype=torch.bool)
    keep = torch.cat([ones, cum < z, ~ones], dim=-1)
    keep[..., :min_keep] = True
    return _threshold_mask(logits, sl, keep)


def typical_mask(logits, p: float, min_keep: int = 1):
    """Locally typical: keep the tokens whose surprise is closest to the
    entropy until their cumulative prob passes p."""
    if p >= 1.0:
        return logits
    log_probs = torch.log_softmax(logits, dim=-1)
    probs = log_probs.exp()
    entropy = -(probs * log_probs).sum(-1, keepdim=True)
    shifted = (-log_probs - entropy).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    probs_sorted = torch.gather(probs, -1, order)
    keep_sorted = (torch.cumsum(probs_sorted, dim=-1) - probs_sorted) < p
    keep_sorted[..., :min_keep] = True
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, NEG_INF)


def sample_token(logits, gen: torch.Generator) -> torch.Tensor:
    """Multinomial draw by Gumbel-max."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


@dataclasses.dataclass
class SamplerState:
    """Carried sampler state: a generator on the logits' device and the
    mirostat mu [B]."""

    gen: torch.Generator
    mu: torch.Tensor

    @staticmethod
    def init(seed: int, batch: int, tau: float, device=None) -> "SamplerState":
        """``device`` None means the card (raises without one)."""
        dev = resolve_device(device)
        return SamplerState(
            gen=torch.Generator(device=dev).manual_seed(max(seed, 0)),
            mu=torch.full((batch,), 2.0 * tau, dtype=torch.float32,
                          device=dev))


def mirostat_v2_step(logits, state: SamplerState, tau: float, eta: float,
                     temp: float):
    """Truncate tokens with surprise > mu (the argmax always survives),
    sample, then mu -= eta * (surprise_drawn - tau)."""
    logits = apply_temperature(logits, temp)
    surprise = surprise_bits(torch.log_softmax(logits, dim=-1))
    masked = torch.where(surprise > state.mu[:, None], NEG_INF, logits)
    best = torch.argmax(logits, dim=-1, keepdim=True)
    masked = masked.scatter(-1, best, torch.gather(logits, -1, best))
    tok = sample_token(masked, state.gen)
    s_drawn = torch.gather(surprise, -1, tok[:, None].long())[:, 0]
    return tok, SamplerState(gen=state.gen,
                             mu=state.mu - eta * (s_drawn - tau))


def mirostat_v1_step(logits, state: SamplerState, tau: float, eta: float,
                     temp: float, n_vocab: int, m: int = 100):
    """Estimate the Zipf exponent from the top-m probs, derive k, top-k
    sample, update mu by the observed surprise."""
    logits = apply_temperature(logits, temp)
    probs = torch.softmax(logits, dim=-1)
    topm = torch.topk(probs, m, dim=-1).values
    i = torch.arange(1, m, dtype=torch.float32, device=logits.device)
    t_i = torch.log((i + 1.0) / i)
    b_i = torch.log(topm[:, :-1] / torch.clamp(topm[:, 1:], min=1e-12))
    s_hat = (t_i * b_i).sum(-1) / (t_i * t_i).sum()
    eps = s_hat - 1.0
    k = torch.pow((eps * torch.pow(2.0, state.mu))
                  / (1.0 - torch.pow(float(n_vocab), -eps)), 1.0 / s_hat)
    k = torch.clamp(k, 1, n_vocab).to(torch.int64)
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(logits.shape[-1],
                                device=logits.device).expand_as(order))
    masked = torch.where(ranks < k[:, None], logits, NEG_INF)
    tok = sample_token(masked, state.gen)
    s_drawn = surprise_bits(torch.gather(torch.log_softmax(logits, dim=-1),
                                         -1, tok[:, None].long())[:, 0])
    return tok, SamplerState(gen=state.gen,
                             mu=state.mu - eta * (s_drawn - tau))


def logit_bias_tensors(gcfg, device=None):
    """``gcfg.logit_bias`` (a dict or (id, bias) pairs) as (ids [N] int64,
    biases [N] f32) on ``device``, or None without one: built once per
    configuration, outside a captured step (a host list copied to the card
    inside a CUDA graph capture is refused)."""
    if not gcfg.logit_bias:
        return None
    items = (gcfg.logit_bias.items() if hasattr(gcfg.logit_bias, "items")
             else gcfg.logit_bias)
    items = list(items)
    dev = resolve_device(device)
    return (torch.tensor([int(t) for t, _ in items], device=dev),
            torch.tensor([float(b) for _, b in items], device=dev))


def sample(logits: torch.Tensor, state: SamplerState, gcfg,
           last_tokens: Optional[torch.Tensor] = None, bias=None):
    """Full pipeline in the reference's order: penalties → [greedy |
    mirostat | top_k → tfs → typical → top_p → temp → draw].
    logits [B, V]; last_tokens [B, T] int (-1 = empty); bias:
    ``logit_bias_tensors(gcfg)`` built in advance (else built here from
    ``gcfg.logit_bias``). Returns (token [B] int32, new state)."""
    logits = logits.float()
    if bias is None:
        bias = logit_bias_tensors(gcfg, logits.device)
    if bias is not None:
        ids, biases = bias
        logits = logits.index_add(1, ids, biases.expand(logits.shape[0], -1))
    if gcfg.temp <= 0:
        return greedy_penalized(logits, last_tokens, gcfg), state
    if last_tokens is not None:
        logits = apply_repetition_penalty(logits, last_tokens,
                                          gcfg.repeat_penalty)
        logits = apply_frequency_presence(logits, last_tokens,
                                          gcfg.frequency_penalty,
                                          gcfg.presence_penalty)
    if gcfg.mirostat == 1:
        return mirostat_v1_step(logits, state, gcfg.mirostat_tau,
                                gcfg.mirostat_eta, gcfg.temp,
                                logits.shape[-1])
    if gcfg.mirostat == 2:
        return mirostat_v2_step(logits, state, gcfg.mirostat_tau,
                                gcfg.mirostat_eta, gcfg.temp)
    logits = top_k_mask(logits, gcfg.top_k)
    logits = tail_free_mask(logits, gcfg.tfs_z)
    logits = typical_mask(logits, gcfg.typical_p)
    logits = top_p_mask(logits, gcfg.top_p)
    logits = apply_temperature(logits, gcfg.temp)
    return sample_token(logits, state.gen), state


# ---- per-row sampling for serving (JAX ``RowParams`` / ``sample_rows``) ----
#
# Randomness: each row carries a (key, step) pair of int64s ([B, 2]); a
# draw's Gumbel noise for vocabulary entry i is a counter-based hash of
# (key, step, i), and each draw advances step by one. A row's draws depend
# only on its own key and step: not on its slot, its neighbours or on how
# the ticks were batched into bursts.

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """x * m mod 2^32 for int64 tensors holding 32-bit values, in halves so
    no int64 product overflows."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def row_key(seed: int, stream: int = 0) -> int:
    """A row's key from a seed and a stream number (JAX ``fold_in``'s
    role): the same pair always gives the same key."""
    h = _mix32(torch.tensor([seed & _M32], dtype=torch.int64))
    return int(_mix32(h ^ _mix32(torch.tensor([stream & _M32]) + 0x9E3779B9)))


def row_keys(seed: int, n: int, device=None) -> torch.Tensor:
    """[n, 2] (key, step = 0) rows for streams 0..n-1 of ``seed``."""
    keys = torch.tensor([[row_key(seed, i), 0] for i in range(n)],
                        dtype=torch.int64)
    return keys.to(resolve_device(device))


def _gumbel(keys: torch.Tensor, width: int) -> torch.Tensor:
    """Gumbel noise [B, width] from each row's (key, step)."""
    h = _mix32(keys[:, :1] ^ _mix32(keys[:, 1:] & _M32))
    idx = torch.arange(width, dtype=torch.int64, device=keys.device)
    bits = _mix32(h ^ _mix32(idx[None, :] + 0x9E3779B9)) >> 8  # 24 bits
    u = (bits.float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def _draw(logits: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row over [B, W] logits (Gumbel-max)."""
    return torch.argmax(logits + _gumbel(keys, logits.shape[-1]),
                        dim=-1).to(torch.int32)


def _next_keys(keys: torch.Tensor) -> torch.Tensor:
    return torch.stack([keys[:, 0], keys[:, 1] + 1], dim=1)


@dataclasses.dataclass
class RowParams:
    """Per-ROW sampling parameters as [B] tensors, so one sampler serves any
    mix of requests."""

    temp: torch.Tensor               # [B] f32; <= 0 → greedy for that row
    top_k: torch.Tensor              # [B] i32; <= 0 → off
    top_p: torch.Tensor              # [B] f32; >= 1 → off
    tfs_z: torch.Tensor              # [B] f32; >= 1 → off
    typical_p: torch.Tensor          # [B] f32; >= 1 → off
    repeat_penalty: torch.Tensor     # [B] f32; 1 → off
    frequency_penalty: torch.Tensor  # [B] f32
    presence_penalty: torch.Tensor   # [B] f32
    bias_ids: torch.Tensor           # [B, MAX_BIAS] i64; -1 = unused entry
    bias_vals: torch.Tensor          # [B, MAX_BIAS] f32
    mirostat: torch.Tensor           # [B] i32; 0 = off, 1/2 = version
    mirostat_tau: torch.Tensor       # [B] f32
    mirostat_eta: torch.Tensor       # [B] f32

    MAX_BIAS = 16  # per-request logit_bias entries

    @staticmethod
    def from_configs(gcfgs, device=None) -> "RowParams":
        dev = resolve_device(device)
        nb = RowParams.MAX_BIAS
        ids = torch.full((len(gcfgs), nb), -1, dtype=torch.int64)
        vals = torch.zeros((len(gcfgs), nb), dtype=torch.float32)
        for r, g in enumerate(gcfgs):
            if g.logit_bias:
                items = (g.logit_bias.items()
                         if hasattr(g.logit_bias, "items") else g.logit_bias)
                for c, (t, v) in enumerate(list(items)[:nb]):
                    ids[r, c] = int(t)
                    vals[r, c] = float(v)

        def arr(name, dt=torch.float32):
            return torch.tensor([getattr(g, name) for g in gcfgs], dtype=dt)

        fields = dict(
            temp=arr("temp"), top_k=arr("top_k", torch.int32),
            top_p=arr("top_p"), tfs_z=arr("tfs_z"),
            typical_p=arr("typical_p"), repeat_penalty=arr("repeat_penalty"),
            frequency_penalty=arr("frequency_penalty"),
            presence_penalty=arr("presence_penalty"),
            bias_ids=ids, bias_vals=vals,
            mirostat=arr("mirostat", torch.int32),
            mirostat_tau=arr("mirostat_tau"),
            mirostat_eta=arr("mirostat_eta"))
        return RowParams(**{k: t.to(dev) for k, t in fields.items()})

    def set_rows(self, idx, other: "RowParams") -> None:
        """Rows ``idx`` take ``other``'s rows, in place."""
        for f in dataclasses.fields(self):
            getattr(self, f.name)[idx] = getattr(other, f.name)


def _sample_rows_candidates(logits, keys, params: RowParams, last_tokens,
                            mu, top_k_max: int):
    """Candidate-domain row sampler: penalties, top_k, nucleus, temperature
    and the draw run on the [B, C] candidate list (C = top_k_max + window)
    of the largest raw logits, never on the full vocabulary. Exact when
    every row has 0 < top_k <= top_k_max and lowering-only penalties (the
    caller's ``pen_lower``): a token outside the raw top C is dominated
    after the penalties by top_k_max unpenalised candidates. The draw runs
    over the C candidates."""
    b, v = logits.shape
    t = last_tokens.shape[1]
    c = min(top_k_max + t, v)
    cvals, cidx = torch.topk(logits, c, dim=-1)                  # [B, C]
    # lax.top_k's order: value descending, ties by ascending index (it
    # decides greedy ties among equal logits)
    cidx, order = torch.sort(cidx, dim=-1)
    cvals, order2 = torch.sort(torch.gather(cvals, 1, order), dim=-1,
                               descending=True, stable=True)
    cidx = torch.gather(cidx, 1, order2)
    hit = (cidx[:, :, None] == last_tokens[:, None, :]) \
        & (last_tokens[:, None, :] >= 0)
    cnt = hit.sum(-1).float()                                   # [B, C]

    rp = params.repeat_penalty[:, None]
    pen = torch.where(cvals > 0, cvals / rp, cvals * rp)
    cvals = torch.where(cnt > 0, pen, cvals)
    cvals = (cvals - cnt * params.frequency_penalty[:, None]
             - (cnt > 0).float() * params.presence_penalty[:, None])

    greedy_tok = torch.gather(cidx, 1, cvals.argmax(-1, keepdim=True))[:, 0]

    # top_k within the candidates: threshold at the k_eff-th penalised
    # value, ties trimmed by candidate order to exactly k_eff kept
    svals = torch.sort(cvals, dim=-1, descending=True).values
    k_eff = params.top_k.long().clamp(1, top_k_max)[:, None]
    kth = torch.gather(svals, 1, k_eff - 1)
    keep = cvals >= kth
    keep &= ~(torch.cumsum(keep.int(), dim=-1) > k_eff)
    masked = torch.where(keep, cvals, NEG_INF)

    # nucleus on the kept candidates
    col = torch.arange(c, device=logits.device)[None, :]
    s_logits = torch.where(col < k_eff, svals, NEG_INF)
    s_probs = torch.softmax(s_logits, dim=-1)
    keep_p = (torch.cumsum(s_probs, dim=-1) - s_probs) < params.top_p[:, None]
    keep_p[:, :1] = True
    n_keep = keep_p.sum(-1, keepdim=True)
    thresh = torch.gather(s_logits, 1, n_keep - 1)
    masked = torch.where(masked < thresh, NEG_INF, masked)

    masked = masked / params.temp.clamp(min=1e-6)[:, None]
    win = _draw(masked, keys)
    drawn = torch.gather(cidx, 1, win[:, None].long())[:, 0]
    tok = torch.where(params.temp <= 0, greedy_tok, drawn).to(torch.int32)
    # rows whose top_k exceeds the bound poison to -1 (the JAX contract)
    tok = torch.where(params.top_k > top_k_max, -1, tok).to(torch.int32)
    return tok, _next_keys(keys), mu


def sample_rows(logits: torch.Tensor, keys: torch.Tensor, params: RowParams,
                last_tokens: Optional[torch.Tensor] = None,
                mu: Optional[torch.Tensor] = None, *, use_bias: bool = True,
                use_tfs_typical: bool = True, use_mirostat: bool = True,
                top_k_max: int = 0, pen_lower: bool = False):
    """Per-row sampling pipeline in the reference order (bias → penalties →
    top_k → tfs → typical → top_p → temp → draw), every parameter a [B]
    tensor (JAX ``sample_rows``).

    logits [B, V]; keys [B, 2] int64 (key, step) per row; last_tokens
    [B, T] (-1 = empty). Returns (tokens [B] int32, new keys, new mu): with
    ``mu`` ([B] f32 carried mirostat state) rows with mirostat 1/2 draw by
    mirostat v1/v2 instead of the truncation pipeline.

    use_bias / use_tfs_typical / use_mirostat: stage gates, each exact when
    the stage is off for every row (its math is then the identity).
    top_k_max: an upper bound on every row's top_k when all rows have
    top_k > 0 (0 = none): top_k then runs by one ``topk`` and a threshold
    instead of a full sort. pen_lower: every row's penalties only lower
    logits; with top_k_max > 0 and the three gates off, the whole pipeline
    runs on a candidate list (``_sample_rows_candidates``)."""
    logits = logits.float()
    if (pen_lower and top_k_max > 0 and not use_bias and not use_tfs_typical
            and not use_mirostat and last_tokens is not None):
        return _sample_rows_candidates(logits, keys, params, last_tokens,
                                       mu, top_k_max)
    b, v = logits.shape
    if use_bias:
        logits = logits.scatter_add(
            1, params.bias_ids.clamp(0, v - 1),
            torch.where(params.bias_ids >= 0, params.bias_vals, 0.0))
    if last_tokens is not None:
        counts = _token_counts(last_tokens, v)
        pen = params.repeat_penalty[:, None]
        penalized = torch.where(logits > 0, logits / pen, logits * pen)
        logits = torch.where(counts > 0, penalized, logits)
        logits = (logits - counts * params.frequency_penalty[:, None]
                  - (counts > 0).float() * params.presence_penalty[:, None])
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)

    if not use_tfs_typical and top_k_max > 0:
        # sort-free top_k: the k_eff-th value as threshold; ties at it keep
        # the right-most tied positions, as the sorted path does
        topvals = torch.topk(logits, top_k_max, dim=-1).values     # desc
        k_eff = params.top_k.long().clamp(1, top_k_max)[:, None]
        kth = torch.gather(topvals, 1, k_eff - 1)
        tied = logits == kth
        need = k_eff - (logits > kth).sum(-1, keepdim=True)
        from_right = tied.flip(-1).cumsum(-1).flip(-1)
        masked = torch.where((logits > kth) | (tied & (from_right <= need)),
                             logits, NEG_INF)
        col = torch.arange(top_k_max, device=logits.device)[None, :]
        s_logits = torch.where(col < k_eff, topvals, NEG_INF)
        tok, new_keys, new_mu = _sample_rows_tail(
            logits, masked, s_logits, greedy_tok, keys, params, mu,
            use_mirostat)
        tok = torch.where(params.top_k > top_k_max, -1, tok).to(torch.int32)
        return tok, new_keys, new_mu

    # one descending sort (ties: higher index first) gives the top_k ranks
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    ranks = torch.argsort(order, dim=-1)
    k_eff = torch.where(params.top_k <= 0, v, params.top_k).long()[:, None]
    masked = torch.where(ranks < k_eff, logits, NEG_INF)
    sorted_logits = torch.gather(masked, 1, order)
    if use_tfs_typical:
        probs = torch.softmax(sorted_logits, dim=-1)
        d1 = probs[:, :-1] - probs[:, 1:]
        d2 = (d1[:, :-1] - d1[:, 1:]).abs()
        # drop the |d2| windows that reach past the last live token
        n_live = (sorted_logits > NEG_INF / 2).sum(-1, keepdim=True)
        d2 = torch.where(torch.arange(v - 2, device=logits.device)[None, :]
                         < n_live - 2, d2, 0.0)
        d2 = d2 / d2.sum(-1, keepdim=True).clamp(min=1e-12)
        cum2 = torch.cumsum(d2, dim=-1)
        z = params.tfs_z[:, None]
        n_keep = torch.where(z >= 1.0, v,
                             1 + (cum2 < z).sum(-1, keepdim=True))
        thresh = torch.gather(sorted_logits, 1, n_keep - 1)
        masked = torch.where(masked < thresh, NEG_INF, masked)

        log_probs = torch.log_softmax(masked, dim=-1)
        p_full = log_probs.exp()
        entropy = -torch.where(p_full > 0, p_full * log_probs,
                               0.0).sum(-1, keepdim=True)
        shifted = (-log_probs - entropy).abs()
        t_order = torch.argsort(shifted, dim=-1, stable=True)
        p_sorted = torch.gather(p_full, 1, t_order)
        keep_t = (torch.cumsum(p_sorted, dim=-1) - p_sorted) \
            < params.typical_p[:, None]
        keep_t[:, :1] = True
        keep = torch.gather(keep_t, 1, torch.argsort(t_order, dim=-1))
        masked = torch.where(keep, masked, NEG_INF)
        # tfs/typical masking does not keep the sorted order: sort again
        s_logits = torch.sort(masked, dim=-1, descending=True).values
    else:
        s_logits = sorted_logits  # a top_k prefix cut keeps the order
    return _sample_rows_tail(logits, masked, s_logits, greedy_tok, keys,
                             params, mu, use_mirostat)


def _sample_rows_tail(logits, masked, s_logits, greedy_tok, keys, params,
                      mu, use_mirostat):
    """Nucleus → temperature → draw → (mirostat), shared by the sorted and
    the sort-free top_k paths. ``s_logits`` holds the live candidates in
    descending order ([B, V] or [B, top_k_max])."""
    b, v = logits.shape
    s_probs = torch.softmax(s_logits, dim=-1)
    keep_p = (torch.cumsum(s_probs, dim=-1) - s_probs) < params.top_p[:, None]
    keep_p[:, :1] = True
    n_keep = keep_p.sum(-1, keepdim=True)
    thresh = torch.gather(s_logits, 1, n_keep - 1)
    masked = torch.where(masked < thresh, NEG_INF, masked)

    masked = masked / params.temp.clamp(min=1e-6)[:, None]
    drawn = _draw(masked, keys)
    tok = torch.where(params.temp <= 0, greedy_tok, drawn).to(torch.int32)
    new_keys = _next_keys(keys)
    if mu is None or not use_mirostat:
        return tok, new_keys, mu

    # per-row mirostat v1/v2: rows with mirostat != 0 replace the pipeline
    # above; all three draws share the row's (key, step)
    lt = logits / params.temp.clamp(min=1e-6)[:, None]
    log_probs_t = torch.log_softmax(lt, dim=-1)
    surprise = surprise_bits(log_probs_t)

    # v2: truncate tokens whose surprise exceeds mu; the argmax survives
    m2 = torch.where(surprise > mu[:, None], NEG_INF, lt)
    best = torch.argmax(lt, dim=-1, keepdim=True)
    m2 = m2.scatter(1, best, torch.gather(lt, 1, best))
    tok2 = _draw(m2, keys)

    # v1: Zipf-estimated dynamic k from the top-m probs, then a top-k draw
    mtop = min(100, v)
    topm = torch.topk(log_probs_t.exp(), mtop, dim=-1).values
    i_idx = torch.arange(1, mtop, dtype=torch.float32, device=logits.device)
    t_i = torch.log((i_idx + 1.0) / i_idx)
    b_i = torch.log(topm[:, :-1] / topm[:, 1:].clamp(min=1e-12))
    s_hat = (t_i * b_i).sum(-1) / (t_i * t_i).sum()
    eps_h = s_hat - 1.0
    k_dyn = torch.pow((eps_h * torch.pow(2.0, mu))
                      / (1.0 - torch.pow(float(v), -eps_h)), 1.0 / s_hat)
    k_dyn = torch.nan_to_num(k_dyn, nan=1.0).clamp(1, v).long()
    ranks_t = torch.argsort(torch.argsort(lt, dim=-1, stable=True).flip(-1),
                            dim=-1)
    m1 = torch.where(ranks_t < k_dyn[:, None], lt, NEG_INF)
    tok1 = _draw(m1, keys)

    tok_m = torch.where(params.mirostat == 1, tok1, tok2)
    s_drawn = torch.gather(surprise, 1, tok_m[:, None].long())[:, 0]
    mu_upd = mu - params.mirostat_eta * (s_drawn - params.mirostat_tau)
    use_m = (params.mirostat > 0) & (params.temp > 0)
    tok = torch.where(use_m, tok_m, tok).to(torch.int32)
    return tok, new_keys, torch.where(use_m, mu_upd, mu)
