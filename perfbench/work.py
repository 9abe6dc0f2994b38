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

A call's bound is its family's count (``families/<family>.py``
``decode_call`` and ``prefill_call``), made of the pieces here, each part
under its kernel class. A family whose work depends on what the program
did, such as the experts its routing touched, may count it from the
program's own counts (``perfbench/spans.py``).
"""

from __future__ import annotations

from collections import Counter

from perfbench.model import Model, family

A8_MAX_ROWS = 100  # W4A8's int8 path: M <= this (the configuration's rule)
# the port's prompt buckets (a frozen copy): a chunk runs its bucket's rows
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def bucket(n: int) -> int:
    return next(b for b in PREFILL_BUCKETS if n <= b)


class Bound(dict):
    """Seconds of roofline bound by kernel class: the stem of a
    ``kernel_classes/`` file (``linear``, ``attention``, or one a family
    brings) -> seconds; an absent class reads 0."""

    def __missing__(self, cls: str) -> float:
        return 0.0

    @property
    def linear(self) -> float:
        return self["linear"]

    @property
    def attention(self) -> float:
        return self["attention"]

    @property
    def total(self) -> float:
        return sum(self.values(), 0.0)

    def __iadd__(self, o: "Bound") -> "Bound":
        for cls, s in o.items():
            self[cls] += s
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


def _span(n: int, window) -> int:
    """Keys one query at KV length n attends to."""
    return n if window is None else min(n, window)


def attention_decode(m: Model, kv_lens, peaks: dict, windows=None) -> float:
    """Bound of one decode call's attention: one query per row at each
    row's KV length (the position written included), in each layer over
    the keys of its window (``windows``: each layer's, None for full;
    default the model's; layers of one window are counted together, in
    order of first use)."""
    if not kv_lens:
        return 0.0
    hd = m.heads * m.head_dim
    t = 0.0
    for window, layers in Counter(windows or m.windows()).items():
        keys = sum(_span(n, window) for n in kv_lens)
        ops = 4.0 * hd * keys
        bytes_ = (keys + len(kv_lens)) * m.kv_bytes_per_token() \
            + len(kv_lens) * hd * 2 * 2
        t += layers * max(ops / peaks["bf16_flops_s"],
                          bytes_ / peaks["hbm_bytes_s"])
    return t


def attention_prefill(m: Model, chunks, peaks: dict, windows=None) -> float:
    """Bound of one prefill call's attention over ``chunks`` [(start,
    take)]: take queries at positions start.. over the causal keys, in
    each layer within its window (``windows`` as ``attention_decode``)."""
    if not chunks:
        return 0.0
    hd = m.heads * m.head_dim
    t = 0.0
    for window, layers in Counter(windows or m.windows()).items():
        ops = bytes_ = 0.0
        for start, take in chunks:
            if window is None:
                keys = take * start + take * (take + 1) / 2
            else:
                keys = sum(_span(start + i + 1, window) for i in range(take))
            ops += 4.0 * hd * keys
            read = start + take if window is None \
                else min(start + take, window + take)
            bytes_ += (read + take) * m.kv_bytes_per_token() \
                + take * hd * 2 * 2
        t += layers * max(ops / peaks["bf16_flops_s"],
                          bytes_ / peaks["hbm_bytes_s"])
    return t


def dense_decode_call(m: Model, kv_lens, peaks: dict,
                      call_rows: int) -> Bound:
    """``decode_call`` of a family whose every layer runs its attention
    and the same int4 linears on every row."""
    r = len(kv_lens)
    return Bound(linear=linears(m, r, r, peaks, call_rows),
                 attention=attention_decode(m, kv_lens, peaks))


def dense_prefill_call(m: Model, chunks, head_rows: int, peaks: dict,
                       call_rows: int) -> Bound:
    """``prefill_call`` of such a family."""
    rows = sum(t for _, t in chunks)
    return Bound(linear=linears(m, rows, head_rows, peaks, call_rows),
                 attention=attention_prefill(m, chunks, peaks))


def decode_call(m: Model, kv_lens, peaks: dict, call_rows: int) -> Bound:
    """One decode forward over the real rows ``kv_lens`` (each row's KV
    length), ``call_rows`` rows run: the family's ``decode_call``."""
    return family(m).decode_call(m, kv_lens, peaks, call_rows)


def prefill_call(m: Model, chunks, head_rows: int, peaks: dict,
                 call_rows: int) -> Bound:
    """One prefill forward of ``chunks`` [(start, take)] (a batched
    admission has several), ``head_rows`` rows needing logits: the
    family's ``prefill_call``."""
    return family(m).prefill_call(m, chunks, head_rows, peaks, call_rows)
