"""The sparse-expert layer of the llama family (``ModelConfig.num_experts``
> 0; Mellum2-12B-A2.5B), run by ``models/llama.py`` in place of a layer's
SwiGLU.

For the normed rows h [n, E] of one call (any row count: a decode tick, a
chunk, a batched admission, a speculative verify):

- the router, a bf16 E -> ``num_experts`` linear (not quantized, as
  published sparse-expert checkpoints keep it), gives f32 logits;
- softmax in f32, the ``experts_per_tok`` largest, renormalised over the
  chosen when ``norm_topk_prob`` (``ops.int4_moe.route``);
- the (row, expert) pairs are sorted by expert with ops of static shape
  (``plan``: no sync, nothing whose shape follows the routing);
- per projection one grouped int4 matmul over every expert's rows
  (gate | up, then down; ``grouped_int4_matmul``), SiLU(gate) * up between;
- each row's k outputs summed with its weights in a fixed order, and the
  residual added (``combine``): no float atomics, so a row's bits do not
  depend on the rows beside it.

Parameters (``LlamaLayerParams``): ``router`` [L, E, X] bf16 and the
experts' ``experts_gate_up`` (E -> 2 F, gate first) and ``experts_down``
(F -> E, K pack-padded) as ``Int4Linear`` stacks of every (layer, expert),
[L X, K/2, N]: layer l's experts are sets l X .. l X + X - 1.

Counters: every call adds (experts given a row, routed pairs) to a device
counter of its device, kept apart for one-token calls (decode) and longer
ones, accumulated inside captured graphs. ``stage_counts`` queues their
copy to the host before a token fetch the caller makes anyway, and
``record_counts`` files what changed since the last fetch as the spans
``serve.experts`` (one-token calls) and ``serve.experts.prefill``
(``utils/tracing.py``): no sync of its own.
"""

from __future__ import annotations

import time

import torch

from tinychatengine_tpu_torch.ops import int4_moe as ops
from tinychatengine_tpu_torch.ops.linear import Int4A8Linear, Int4Linear
from tinychatengine_tpu_torch.utils import tracing

# device -> int64 [4]: (sets, pairs) of one-token calls, then of others
_STATS: dict = {}
_HOST: dict = {}   # device -> its host copy (pinned on the card)
_LAST: dict = {}   # device -> the values last filed


def _key(device) -> torch.device:
    """``device`` with its index (``"cuda"`` names the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stats(device) -> torch.Tensor:
    """The expert counters of ``device`` (made at its first call: an eager
    forward, before any capture reads them; a normal tensor even under
    ``inference_mode``, so forwards outside it may add to it too)."""
    dev = _key(device)
    t = _STATS.get(dev)
    if t is None:
        with torch.inference_mode(False):
            t = _STATS[dev] = torch.zeros(4, dtype=torch.int64, device=dev)
    return t


def refuse_parallel(cfg, what: str) -> None:
    """Sparse-expert models have no tensor-, sequence- or
    pipeline-parallel path (no expert parallelism): raise for one."""
    if cfg.num_experts:
        raise ValueError(f"{cfg.name}: a sparse-expert model has no {what} "
                         f"path (its experts are not sharded)")


def forward(lyr, cfg, h: torch.Tensor, x: torch.Tensor, li: int
            ) -> torch.Tensor:
    """x + the expert layer of layer ``li`` over h (both [B, S, E] bf16)."""
    gu_w, down_w = lyr.experts_gate_up, lyr.experts_down
    if not isinstance(gu_w, Int4Linear) or isinstance(gu_w, Int4A8Linear):
        raise NotImplementedError("the expert layer runs W4A16 int4 experts")
    b, s, e = h.shape
    n, ne, k = b * s, cfg.num_experts, cfg.experts_per_tok
    h2 = h.reshape(n, e).to(torch.bfloat16)
    logits = torch.matmul(h2.float(), lyr.router[li].float())
    ids, w = ops.route(logits, k, cfg.norm_topk_prob)
    counts = stats(h.device)
    t = ops.tile_rows(n * k, ne)
    src, slot_of, offsets, tiles = ops.plan(
        ids, ne, t, counts[0:2] if s == 1 else counts[2:4])
    xs = h2.index_select(0, src)
    kp = 2 * gu_w.packed.shape[-2]
    if kp > e:
        xs = torch.nn.functional.pad(xs, (0, kp - e))
    gu = ops.grouped_int4_matmul(xs, gu_w.packed, gu_w.scales,
                                 gu_w.group_size, li * ne, offsets, tiles,
                                 ne, t)
    act = ops.expert_act(gu, 2 * down_w.packed.shape[-2])
    yd = ops.grouped_int4_matmul(act, down_w.packed, down_w.scales,
                                 down_w.group_size, li * ne, offsets, tiles,
                                 ne, t)
    return ops.combine(yd, slot_of, w, x.reshape(n, e)).reshape(b, s, e)


def stage_counts(device):
    """Queue the copy of ``device``'s expert counters to the host, ahead of
    a token fetch on the same stream (None: no expert layer ran there)."""
    dev = _key(device)
    t = _STATS.get(dev)
    if t is None:
        return None
    host = _HOST.get(dev)
    if host is None:
        host = _HOST[dev] = torch.zeros(
            4, dtype=torch.int64, pin_memory=dev.type == "cuda")
    host.copy_(t, non_blocking=True)
    return dev, host


def record_counts(staged) -> None:
    """After the fetch that followed ``stage_counts``: file the counts
    since the last fetch as ``serve.experts`` (a: experts given a row over
    the calls' layers, b: routed pairs) and ``serve.experts.prefill``,
    each only where it moved, under the span open on this thread."""
    if staged is None:
        return
    dev, host = staged
    now = host.tolist()
    last = _LAST.get(dev, [0, 0, 0, 0])
    _LAST[dev] = now
    t = time.perf_counter_ns()
    parent = tracing.RECORDER.current()
    for name, i in ((tracing.EXPERTS, 0), (tracing.EXPERTS_PREFILL, 2)):
        sets, pairs = now[i] - last[i], now[i + 1] - last[i + 1]
        if pairs:
            tracing.record(name, t, t, parent=parent, a=sets, b=pairs)
