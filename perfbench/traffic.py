"""The one traffic generator: every mix is a data file
(``traffic/<mix>.json``) that this module reads.

The schedule is the mix's own: sizes, their order and the arrival times
come from the mix's ``schedule_seed``, the same for every run seed; the
run seed draws the token ids (and, elsewhere, the weights). A length
distribution (``lognormal``: ``median``, ``sigma``, clipped to
[``min``, ``max``]) gives n lengths at its quantiles (i + 0.5) / n; the
prompt and output lengths are paired by a permutation and the sampling
configurations assigned in turn. Open-loop arrivals are a Poisson process:
the n gaps of a segment are exponential quantiles at rate ``rate_rps`` in
a permuted order, scaled to fill the segment exactly, so a window of s
seconds receives round(rate * s) requests. Fixing the order keeps the
seed from changing the work: at 0.8 of the knee the order of the same
requests alone moved a cell's TTFT p95 by a factor of 2.8 between seeds.

An open-loop schedule has three segments: the pre-roll (``preroll_s``,
before the window opens, to reach steady occupancy), the window (the
requests counted) and the tail (arrivals that go on while the window's
requests drain, ``drain_limit_s``, so the load does not drop under them).
A closed-loop mix (``calls``) is a fixed set of ``set_size`` calls that
the run cycles through.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ID_MARGIN = 100  # token ids are drawn from [ID_MARGIN, vocab - ID_MARGIN)


@dataclasses.dataclass
class Item:
    """One request (open loop) or call (closed loop)."""

    index: int
    segment: str            # "pre" | "win" | "tail" | "calls"
    due: float              # seconds after the schedule's start (open loop)
    prompt: np.ndarray      # [n] int64
    n_out: int
    sampling: int           # index into the mix's ``sampling`` list


def lengths(dist: dict, n: int) -> np.ndarray:
    """n lengths at the quantiles (i + 0.5) / n of ``dist``."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.round(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(x, dist["min"], dist["max"]).astype(np.int64)


def gaps(rate: float, n: int, span: float, rng: np.random.Generator
         ) -> np.ndarray:
    """n exponential inter-arrival gaps at ``rate`` (quantiles), in
    ``rng``'s order, scaled to sum to ``span``."""
    if n == 0:
        return np.zeros(0)
    g = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    g = rng.permutation(g)
    return g * (span / g.sum())


def _set(mix: dict, n: int) -> list:
    """The fixed multiset of (prompt length, output length, sampling)."""
    p = lengths(mix["prompt"], n)
    o = lengths(mix["output"], n)
    o = o[np.random.default_rng(mix["schedule_seed"]).permutation(n)]
    k = len(mix["sampling"])
    return [(int(p[i]), int(o[i]), i % k) for i in range(n)]


def _items(mix: dict, n: int, segment: str, order, ids, vocab: int,
           start: int) -> list:
    """The segment's n requests in ``order``'s permutation, their token
    ids from ``ids``."""
    out = []
    for j, (pl, ol, s) in enumerate(order.permutation(
            np.array(_set(mix, n), dtype=np.int64)).tolist()):
        ids_ = ids.integers(ID_MARGIN, vocab - ID_MARGIN, pl, dtype=np.int64)
        out.append(Item(start + j, segment, 0.0, ids_, int(ol), int(s)))
    return out


def open_loop(mix: dict, seed: int, seconds: float, vocab: int,
              rate: float = None) -> list:
    """The schedule of an open-loop mix: items with due times from the
    schedule's start (the window opens at ``preroll_s``)."""
    rate = rate or mix["rate_rps"]
    ids = _run_rng(seed, 1)
    segs = (("pre", mix["preroll_s"]), ("win", seconds),
            ("tail", mix["drain_limit_s"]))
    items, t0 = [], 0.0
    for k, (seg, span) in enumerate(segs):
        n = int(round(rate * span))
        order = np.random.default_rng([mix["schedule_seed"], k])
        its = _items(mix, n, seg, order, ids, vocab, len(items))
        for it, t in zip(its, t0 + np.cumsum(gaps(rate, n, span, order))):
            it.due = float(t)
        items += its
        t0 += span
    return items


def closed_loop(mix: dict, seed: int, vocab: int) -> list:
    """The fixed set of calls of a closed-loop mix, in the mix's order."""
    order = np.random.default_rng([mix["schedule_seed"], 0])
    return _items(mix, mix["set_size"], "calls", order, _run_rng(seed, 2),
                  vocab, 0)


def _run_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
