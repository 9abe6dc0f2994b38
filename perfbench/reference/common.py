"""Pieces of the plain references: f32 arithmetic in plain PyTorch, TF32
off, imports nothing of the port.

A sequence (``Seq``) is run whole, every position from 0, with no cache,
no batching and no kernel. The activation precision of each linear's input
is chosen per row (``row_bits``, a precision code: ``FULL`` = the f32 input
as it is; 8 or 4 = the input quantized per row and group of ``group`` to
that many bits, scale = absmax / (2^(bits-1) - 1), round half to even,
clipped; ``FP8`` = scaled per row and group to e4m3's largest value, 448,
and rounded to e4m3), which is how the configuration's W4A8 runs its
decode rows. ``kv_bits`` and ``res_bits`` quantize K and V (per position
and head) and the residual stream (per row and group) the same way; at
``FULL`` they stay f32. The control lowers each precision the
configuration states by one step through these fields.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

QUERY_BLOCK = 512  # queries per block of the attention's scores
FULL, INT8, INT4, FP8 = 16, 8, 4, -8   # precision codes
PRECISIONS = {"full": FULL, "int8": INT8, "int4": INT4, "fp8": FP8}
FP8_MAX = 448.0  # e4m3's largest finite value


@dataclasses.dataclass
class Seq:
    ids: np.ndarray        # [T] int64: the prompt and the served tokens
    want: np.ndarray       # positions whose logits are wanted (ascending)
    row_bits: np.ndarray   # [T] precision of the layer linears' input rows
    head_bits: int = FULL  # the lm_head's rows
    kv_bits: int = FULL    # K and V, per position and head
    res_bits: int = FULL   # the residual stream after each add


def strict_f32() -> None:
    """Full f32 products: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_quant(x: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """x [M, K] f32 quantized per (row, group) to precision ``bits`` and
    back."""
    if bits == FULL:
        return x
    m, k = x.shape
    g = x.reshape(m, k // group, group)
    amax = g.abs().amax(-1, keepdim=True).clamp(min=1e-8)
    if bits == FP8:
        scale = amax / FP8_MAX
        q = (g / scale).to(torch.float8_e4m3fn).float()
    else:
        qmax = float(2 ** (bits - 1) - 1)
        scale = amax / qmax
        q = torch.clamp(torch.round(g / scale), -qmax, qmax)
    return (q * scale).reshape(m, k)


def kv_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """K or V [T, H, D] quantized per position and head."""
    t, h, d = x.shape
    return fake_quant(x.reshape(t * h, d), bits, d).reshape(t, h, d)


def linear(x: torch.Tensor, w: torch.Tensor, bits: torch.Tensor,
           group: int, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] in f32, each row's input at its ``bits``."""
    y = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                    device=x.device)
    for b in torch.unique(bits).tolist():
        rows = (bits == b).nonzero()[:, 0]
        y[rows] = fake_quant(x[rows], int(b), group) @ w
    if bias is not None:
        y += bias
    return y


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of one sequence in f32: q [T, Hq, D], k / v
    [T, Hkv, D] (query head h reads KV head h // (Hq / Hkv)); position i
    sees keys j <= i, and j > i - window with a window. Returns [T, Hq*D]."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    grp = hq // hkv
    qg = q.reshape(t, hkv, grp, d)
    out = torch.empty((t, hkv, grp, d), dtype=torch.float32, device=q.device)
    keys = torch.arange(t, device=q.device)
    scale = 1.0 / math.sqrt(d)
    for a in range(0, t, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, t)
        s = torch.einsum("qhgd,khd->hgqk", qg[a:b], k[:b]) * scale
        pos = torch.arange(a, b, device=q.device)[:, None]
        ok = keys[None, :b] <= pos
        if window is not None:
            ok &= keys[None, :b] > pos - window
        s = s.masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("hgqk,khd->qhgd", p, v[:b])
    return out.reshape(t, hq * d)


def row_bits_tensor(seqs, device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([s.row_bits for s in seqs]),
                           device=device)


def wanted_rows(seqs) -> tuple:
    """(flat row index of every wanted position, per-seq counts)."""
    rows, counts, base = [], [], 0
    for s in seqs:
        rows.append(base + np.asarray(s.want, np.int64))
        counts.append(len(s.want))
        base += len(s.ids)
    return np.concatenate(rows), counts
