"""The work the model's operations need, counted from its widths and the
real rows, chunk lengths and KV lengths (dead rows and bucket padding are
not work), and each operation's roofline bound: the larger of its
operations over the peak rate of its arithmetic and its bytes over the
HBM rate (``peaks.json``). Each input byte is counted read once and each
output byte written once.

An operation is one launch's worth of work: a layer's linear over the rows
of one forward call (its packed weights and scales read once, bf16
activations in and out), the lm_head over the rows that need logits, or a
layer's attention over one call's rows (each row's K and V read once, its
new K and V written, q read and the output written). W4A8 linears at most
``A8_MAX_ROWS`` rows run on the int8 tensor cores (1979 TOP/s), every
other linear and all attention at bf16's 989 TFLOP/s. The elementwise
operations (norms, RoPE, activations, residuals, sampling) are not
counted, so a bound here is a lower bound of the time.
"""

from __future__ import annotations

import dataclasses

from perfbench.model import Model

A8_MAX_ROWS = 100  # W4A8's int8 path: M <= this (the configuration's rule)
# the port's prompt buckets (a frozen copy): a chunk runs its bucket's rows
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def bucket(n: int) -> int:
    return next(b for b in PREFILL_BUCKETS if n <= b)


@dataclasses.dataclass
class Bound:
    """Seconds of roofline bound, by class."""

    linear: float = 0.0
    attention: float = 0.0

    @property
    def total(self) -> float:
        return self.linear + self.attention

    def __iadd__(self, o: "Bound") -> "Bound":
        self.linear += o.linear
        self.attention += o.attention
        return self


def _linear_bound(m: Model, k: int, n: int, rows: int, peaks: dict,
                  a8: bool) -> float:
    if rows <= 0:
        return 0.0
    ops = 2.0 * rows * k * n
    w_bytes = k * n / 2 + (k // m.group) * n * 2
    bytes_ = w_bytes + rows * (k + n) * 2
    rate = peaks["int8_ops_s"] if a8 else peaks["bf16_flops_s"]
    return max(ops / rate, bytes_ / peaks["hbm_bytes_s"])


def linears(m: Model, rows: int, head_rows: int, peaks: dict,
            call_rows: int = None) -> float:
    """Bound of one forward call's linears: every layer's over ``rows``
    real rows, the lm_head over ``head_rows``. ``call_rows``: the rows the
    call runs (padding and dead rows included), which pick the W4A8 path
    (default ``rows``)."""
    call_rows = rows if call_rows is None else call_rows
    a8 = m.scheme == "w4a8" and call_rows <= A8_MAX_ROWS
    t = m.layers * sum(_linear_bound(m, k, n, rows, peaks, a8)
                       for _, k, n, _ in m.linears())
    head_a8 = m.scheme == "w4a8" and head_rows <= A8_MAX_ROWS
    return t + _linear_bound(m, m.hidden, m.vocab, head_rows, peaks, head_a8)


def _span(m: Model, n: int) -> int:
    """Keys one query at KV length n attends to."""
    return n if m.window is None else min(n, m.window)


def attention_decode(m: Model, kv_lens, peaks: dict) -> float:
    """Bound of one decode call's attention: one query per row at each
    row's KV length (the position written included)."""
    if not kv_lens:
        return 0.0
    hd = m.heads * m.head_dim
    keys = sum(_span(m, n) for n in kv_lens)
    ops = 4.0 * hd * keys
    bytes_ = (keys + len(kv_lens)) * m.kv_bytes_per_token() \
        + len(kv_lens) * hd * 2 * 2
    return m.layers * max(ops / peaks["bf16_flops_s"],
                          bytes_ / peaks["hbm_bytes_s"])


def attention_prefill(m: Model, chunks, peaks: dict) -> float:
    """Bound of one prefill call's attention over ``chunks`` [(start,
    take)]: take queries at positions start.. over the causal keys."""
    if not chunks:
        return 0.0
    hd = m.heads * m.head_dim
    ops = bytes_ = 0.0
    for start, take in chunks:
        if m.window is None:
            keys = take * start + take * (take + 1) / 2
        else:
            keys = sum(_span(m, start + i + 1) for i in range(take))
        ops += 4.0 * hd * keys
        read = start + take if m.window is None \
            else min(start + take, m.window + take)
        bytes_ += (read + take) * m.kv_bytes_per_token() + take * hd * 2 * 2
    return m.layers * max(ops / peaks["bf16_flops_s"],
                          bytes_ / peaks["hbm_bytes_s"])


def decode_call(m: Model, kv_lens, peaks: dict, call_rows: int) -> Bound:
    """One decode forward over the real rows ``kv_lens`` (each row's KV
    length), ``call_rows`` rows run."""
    r = len(kv_lens)
    return Bound(linears(m, r, r, peaks, call_rows),
                 attention_decode(m, kv_lens, peaks))


def prefill_call(m: Model, chunks, head_rows: int, peaks: dict,
                 call_rows: int) -> Bound:
    """One prefill forward of ``chunks`` [(start, take)] (a batched
    admission has several), ``head_rows`` rows needing logits."""
    rows = sum(t for _, t in chunks)
    return Bound(linears(m, rows, head_rows, peaks, call_rows),
                 attention_prefill(m, chunks, peaks))
