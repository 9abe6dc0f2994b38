"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``reference/<family>.py``, f32, TF32 off) runs once over each
sampled request's prompt and served tokens, with weights made again from
the seed. At each compared position it penalizes its logits as the
request asked (repetition penalty over the request's window of the prompt
and the tokens served so far) and reads the gap by which the served
token's logit lies below the best, as a share of that position's largest
|logit|. Only greedy tokens are judged (a sampled token may lawfully lie
below the best). Over all compared positions it reads three numbers:

- ``gap``: the widest gap;
- ``gap_mean``: the mean gap (a position whose token is the reference's
  best adds 0). A token flips where its error exceeds the best's margin,
  so the mean grows as the square of the error, where the widest grows
  about as the error;
- ``flips``: the share of positions whose token is not the reference's
  best.

A cell's limits file names the numbers it compares, each with its limit.
Besides these, ``lower_launches`` counts the launches, in the whole run,
of the port's kernels that compute below the configuration's precision
(the limits file's ``lower_kernels``, patterns of the launch counter's
names: int8 KV where the configuration states bf16 KV, the W4A8 kernel
where it states W4A16); its limit is 0. The port's own int8 KV and W4A8
paths err no more than its bf16 path does, so no number of the tokens
tells them apart from the configuration's (``PERF.md``); this one does.

The reference follows the configuration's precision: W4A8 quantizes a
linear's input rows to int8 per group where the call that runs them has at
most ``work.A8_MAX_ROWS`` rows. Each sampled request carries its
admission: the prompt's chunks and the rows of the call that ran each (a
chunk its bucket, a batched admission its batch times its bucket). Every
decode row (a tick runs its slots, 64 or fewer; a generate step one row)
and the lm_head's rows run int8. W4A16 keeps every input in full
precision.

A control is the same reference with precisions lowered as its steps say
(``steps``: ``{"linear": {"int8": "int4", "full": "int8"}, "kv": "int8",
"residual": "int8"}``, any of the three keys; ``linear`` maps the
precision of each linear input row, ``kv`` and ``residual`` name the
precision K and V and the residual stream take instead of full). At each
compared position of the same prompts and tokens it takes its own first
choice after the penalty and reads the same three numbers of it.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from perfbench import spec, work
from perfbench.reference.common import FULL, INT8, PRECISIONS, Seq, strict_f32
from perfbench.weights import Weights

NUMBERS = ("gap", "gap_mean", "flips")


def lower_launches(counts: dict, patterns: list) -> int:
    """Launches in ``counts`` (the port's launch counter) of the kernels
    whose names match any of ``patterns``."""
    return int(sum(v for k, v in counts.items()
                   if any(re.search(p, k) for p in patterns)))


def row_bits(m, n_prompt: int, n_served: int, admission) -> tuple:
    """(precision of each row of prompt + served[:-1], the lm_head's).
    ``admission``: (start, take, rows of the call) of each prompt chunk."""
    if m.scheme != "w4a8":
        return np.full(n_prompt + n_served - 1, FULL, np.int64), FULL
    bits = np.full(n_prompt + n_served - 1, INT8, np.int64)
    for start, take, rows in admission:
        if rows > work.A8_MAX_ROWS:
            bits[start:start + take] = FULL
    return bits, INT8


def lowered(steps: dict) -> dict:
    """A control's ``steps`` as precision codes: {"linear": {code: code},
    "kv": code, "residual": code}."""
    return {"linear": {PRECISIONS[a]: PRECISIONS[b]
                       for a, b in steps.get("linear", {}).items()},
            "kv": PRECISIONS[steps.get("kv", "full")],
            "residual": PRECISIONS[steps.get("residual", "full")]}


def sequences(m, samples: list, steps: dict = None) -> list:
    """The reference's sequences of ``samples`` (each runs its prompt and
    served tokens up to its last compared one); with a control's
    ``steps`` the precisions they name lowered."""
    low = lowered(steps) if steps else None
    out = []
    for s in samples:
        n, want = len(s["prompt"]), np.asarray(s["want"], np.int64)
        k = int(want.max()) + 1
        bits, head = row_bits(m, n, k, s["admission"])
        extra = {}
        if low:
            lin = low["linear"]
            bits = np.vectorize(lambda b: lin.get(b, b))(bits)
            head = lin.get(head, head)
            extra = dict(kv_bits=low["kv"], res_bits=low["residual"])
        out.append(Seq(ids=np.concatenate([s["prompt"], s["served"][:k - 1]]),
                       want=n - 1 + want, row_bits=bits, head_bits=head,
                       **extra))
    return out


def penalized(logits: torch.Tensor, context: np.ndarray, positions,
              sampling: dict) -> torch.Tensor:
    """[k, V] logits with the request's repetition penalty applied at each
    position p of ``positions`` (context indices of the tokens predicted:
    its window is the ``repeat_last_n`` tokens before p)."""
    pen = float(sampling.get("repeat_penalty", 1.1))
    w = int(sampling.get("repeat_last_n", 64))
    if pen == 1.0 or w == 0:
        return logits
    k, v = logits.shape
    ctx = torch.as_tensor(context, device=logits.device)
    hit = torch.zeros((k, v), dtype=torch.bool, device=logits.device)
    for j, end in enumerate(positions):
        hit[j, ctx[max(0, int(end) - w):int(end)]] = True
    return torch.where(hit, torch.where(logits > 0, logits / pen,
                                        logits * pen), logits)


def gaps_of(ref: torch.Tensor, tokens: torch.Tensor, context, positions,
            sampling) -> torch.Tensor:
    """Each position's gap of ``tokens`` below the penalized best, as a
    share of the raw logits' largest magnitude."""
    p = penalized(ref, context, positions, sampling)
    best = p.max(-1).values
    got = p.gather(1, tokens[:, None].long())[:, 0]
    return (best - got) / ref.abs().max(-1).values


def summary(gaps: list) -> dict:
    """``NUMBERS`` of the compared positions' gaps."""
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    if len(g) == 0:
        return {"gap": float("inf"), "gap_mean": float("inf"),
                "flips": float("inf")}
    return {"gap": float(g.max()), "gap_mean": float(g.mean()),
            "flips": float((g > 0).float().mean())}


def readings(m, samples: list, seed: int, device,
             controls: dict = None) -> dict:
    """``NUMBERS`` over ``samples``, and for each control in ``controls``
    (name -> its ``steps``) its readings ``control.<name>.<number>``."""
    strict_f32()
    if not samples:
        return dict(summary([]), tokens=0, requests=0)
    w = Weights(m, seed, device)
    fam = spec.reference(m.family, m.root)
    ref = fam.logits(w, sequences(m, samples), device)
    ctxs, poss = [], []
    for s in samples:
        ctxs.append(np.concatenate([s["prompt"], s["served"]]))
        poss.append(len(s["prompt"]) + np.asarray(s["want"], np.int64))
    gaps = [gaps_of(ref[i], torch.as_tensor(s["served"][s["want"]],
                                            device=device),
                    ctxs[i], poss[i], s["sampling"])
            for i, s in enumerate(samples)]
    out = dict(summary(gaps), tokens=int(sum(len(s["want"])
                                             for s in samples)),
               requests=len(samples))
    for name, steps in (controls or {}).items():
        low = fam.logits(w, sequences(m, samples, steps), device)
        cg = []
        for i, s in enumerate(samples):
            # the control decodes nothing: at each compared position of
            # the same tokens, its own first choice after the penalty
            first = penalized(low[i], ctxs[i], poss[i],
                              s["sampling"]).argmax(-1)
            cg.append(gaps_of(ref[i], first, ctxs[i], poss[i],
                              s["sampling"]))
        for k, v in summary(cg).items():
            out[f"control.{name}.{k}"] = v
    return out


def judge(read: dict, lim: dict, attempted: int, failed: int) -> tuple:
    """(correct, checks): every number compared, with its limit (the
    limits file's ``compare``), then the failed requests and the count of
    compared tokens."""
    checks = {k: {"value": read[k], "limit": v["limit"]}
              for k, v in lim["compare"].items()}
    checks["failed"] = {"value": failed, "limit": 0}
    checks["compared_tokens"] = {"value": read["tokens"],
                                 "limit": lim["compared_tokens_min"]}
    ok = (all(read[k] <= v["limit"] for k, v in lim["compare"].items())
          and failed == 0 and read["tokens"] >= lim["compared_tokens_min"]
          and attempted > 0)
    return ok, checks
