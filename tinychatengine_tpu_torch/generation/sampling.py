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
import math
from typing import Optional

import torch

NEG_INF = -1e30


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
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
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
    pen = torch.where(raw > 0, raw / gcfg.repeat_penalty,
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
    return logits / max(temp, 1e-6)


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
        dev = torch.device("cpu" if device is None else device)
        return SamplerState(
            gen=torch.Generator(device=dev).manual_seed(max(seed, 0)),
            mu=torch.full((batch,), 2.0 * tau, dtype=torch.float32,
                          device=dev))


def mirostat_v2_step(logits, state: SamplerState, tau: float, eta: float,
                     temp: float):
    """Truncate tokens with surprise > mu (the argmax always survives),
    sample, then mu -= eta * (surprise_drawn - tau)."""
    logits = apply_temperature(logits, temp)
    surprise = -torch.log_softmax(logits, dim=-1) / math.log(2.0)
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
    s_drawn = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                            tok[:, None].long())[:, 0] / math.log(2.0)
    return tok, SamplerState(gen=state.gen,
                             mu=state.mu - eta * (s_drawn - tau))


def sample(logits: torch.Tensor, state: SamplerState, gcfg,
           last_tokens: Optional[torch.Tensor] = None):
    """Full pipeline in the reference's order: penalties → [greedy |
    mirostat | top_k → tfs → typical → top_p → temp → draw].
    logits [B, V]; last_tokens [B, T] int (-1 = empty). Returns
    (token [B] int32, new state)."""
    logits = logits.float()
    if gcfg.logit_bias:
        items = (gcfg.logit_bias.items() if hasattr(gcfg.logit_bias, "items")
                 else gcfg.logit_bias)
        ids = torch.tensor([int(t) for t, _ in items], device=logits.device)
        biases = torch.tensor([float(b) for _, b in items],
                              device=logits.device)
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
