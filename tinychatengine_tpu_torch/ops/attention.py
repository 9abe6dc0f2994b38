"""Attention over the layer-stacked KV cache: ``flash_decode`` (one query
position), ``flash_prefill`` (a causal prompt chunk),
``flash_decode_paged`` (one query position over a page pool) and
``int8_decode`` (OPT SmoothQuant decode over the raw int8 cache), with
their plain PyTorch versions.

Counterpart of the JAX package's ``ops/attention.py``. The kernels are
``csrc/flash_decode.cu`` and ``csrc/flash_decode_paged.cu`` (thin entry
points over one body, ``csrc/flash_decode.cuh``) and
``csrc/flash_prefill.cu``: fp32 online softmax,
probabilities rounded to bf16 before the PV product, and only the valid key
range visited. Each
source holds a bf16 kernel and an int8 one (launch counters
``flash_decode_int8``, ``flash_prefill_int8``, ``flash_decode_paged_int8``)
for the int8 cache with per-position f32 scales, with the TPU kernels'
quantized arithmetic: scores of the exact codes times sm_scale, then times
k_scale; max and sum over the unscaled probabilities; probabilities times
v_scale rounded to bf16 against the exact V codes.
``csrc/int8_decode.cu`` keeps the Int8OPT dataflow: int32 scores, a
softmax against the row's final stats, probabilities requantized x127 to
int8, an int32 PV product; its key range is split into chunks of
``INT8_SPLIT`` keys from position 0, the chunks' statistics merged in a
fixed order, the int32 partials summed exactly.

Decode splits each row's key range over blocks: chunks of ``DECODE_SPLIT``
keys counted from position 0, one partial softmax
each, merged in ascending order by a second kernel. The partition depends
on key positions alone, so dense and paged decode, and a scalar or a
device ``[B]`` length, give bit-identical outputs; the wrapper sizes the
grid from the scalar length, S or ``max_pages * P`` (``decode_splits``)
and never reads device lengths on the host. With device lengths,
``flash_decode`` takes JAX's static ``ctx_cap`` (a bound on every length):
the grid covers ``min(ctx_cap, S)`` keys, which drops only split blocks
that hold no key, so the output bits do not change.

The plain versions have ``attention_xla``'s semantics and cast points:
dense masked scores in f32, softmax, probabilities cast to the cache's
dtype, PV in f32, result in q.dtype.
"""

from __future__ import annotations

import ctypes

import torch

from tinychatengine_tpu_torch.ops import _build

NEG_INF = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# keys per split of the decode kernels (csrc/flash_decode.cuh's SPLIT)
DECODE_SPLIT = 128


def decode_splits(cap: int) -> int:
    """The decode kernels' grid depth for rows of at most ``cap`` keys:
    ceil(cap / DECODE_SPLIT), at least 1 (a scalar length of 0 still
    launches one empty split, and the merge writes zeros)."""
    return max(1, -(-int(cap) // DECODE_SPLIT))


def attention_plain(q, cache_k, cache_v, positions, kv_valid_len,
                    window: int | None = None) -> torch.Tensor:
    """Dense masked GQA attention (``attention_xla``).

    q [B, S, Hq, D]; cache_k/v [B, Hkv, S_max, D] (bf16, dequantized);
    positions [B, S] absolute query positions; kv_valid_len int or [B].
    Returns [B, S, Hq*D] in q.dtype."""
    b, s, hq, d = q.shape
    hkv, smax = cache_k.shape[1], cache_k.shape[2]
    groups = hq // hkv
    qh = q.permute(0, 2, 1, 3).reshape(b, hkv, groups, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qh.float(),
                          cache_k.float()) * (1.0 / d ** 0.5)
    col = torch.arange(smax, device=q.device)
    valid = torch.as_tensor(kv_valid_len, device=q.device).reshape(-1, 1, 1)
    pos = positions[:, :, None]
    allowed = (col[None, None, :] <= pos) & (col[None, None, :] < valid)
    if window is not None:
        allowed = allowed & (col[None, None, :] > pos - window)
    logits = torch.where(allowed[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs.to(cache_v.dtype).float(),
                       cache_v.float())
    return (out.to(q.dtype).reshape(b, hq, s, d).permute(0, 2, 1, 3)
            .reshape(b, s, hq * d))


def read_cache_layer(cache_k, cache_v, layer_idx, k_scale, v_scale):
    """One layer's [B, Hkv, S_max, D] views, int8 dequantized to bf16."""
    k, v = cache_k[layer_idx], cache_v[layer_idx]
    if k_scale is not None:
        k = (k.float() * k_scale[layer_idx][..., None]).to(torch.bfloat16)
        v = (v.float() * v_scale[layer_idx][..., None]).to(torch.bfloat16)
    return k, v


def _per_batch(value, b: int, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int64,
                           device=device).reshape(-1).expand(b)


def flash_decode_plain(q, cache_k, cache_v, layer_idx, lengths, k_scale=None,
                       v_scale=None, *, window: int | None = None
                       ) -> torch.Tensor:
    """q [B, Hq, D] at position lengths[b] - 1 against one cache layer."""
    b, hq, d = q.shape
    ck, cv = read_cache_layer(cache_k, cache_v, layer_idx, k_scale, v_scale)
    ln = _per_batch(lengths, b, q.device)
    out = attention_plain(q[:, None], ck, cv, (ln - 1)[:, None], ln, window)
    return out.reshape(b, hq, d)


def flash_prefill_plain(q, cache_k, cache_v, layer_idx, start, length,
                        k_scale=None, v_scale=None, *,
                        window: int | None = None) -> torch.Tensor:
    """q [B, S, Hq, D] at positions start..start+S-1 (start int or [B])
    against one cache layer that already holds the chunk."""
    b, s = q.shape[:2]
    ck, cv = read_cache_layer(cache_k, cache_v, layer_idx, k_scale, v_scale)
    st = _per_batch(start, b, q.device)
    positions = st[:, None] + torch.arange(s, device=q.device)[None, :]
    return attention_plain(q, ck, cv, positions, length, window)


def _lengths_arg(value, b: int, device, smax: int):
    """(device pointer, scalar) for an int or a [B] int32 CUDA tensor
    (a tensor's values are the caller's to keep within [0, smax])."""
    if isinstance(value, torch.Tensor):
        if value.dtype != torch.int32 or value.device != device \
                or value.numel() != b or not value.is_contiguous():
            raise ValueError("per-batch lengths/starts must be a contiguous "
                             f"int32 [B={b}] tensor on {device}")
        return value.data_ptr(), 0
    if not 0 <= int(value) <= smax:
        raise ValueError(f"position {int(value)} outside the cache (S={smax})")
    return None, int(value)


def _check_storage(cache_k, cache_v, k_scale, v_scale) -> bool:
    """The storage the kernels take: the stacked cache [L, B, Hkv, S, D]
    or the page pool [L, n_pages, Hkv, P, D], contiguous, as bf16 with no
    scales or as int8 codes with contiguous f32 k_scale and v_scale of
    shape ``cache_k.shape[:-1]`` on the codes' device. Returns whether it
    is int8; raises ``ValueError`` on anything else."""
    if cache_k.dim() != 5 or cache_v.shape != cache_k.shape:
        raise ValueError("cache k and v must have one 5-D shape")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("cache must be contiguous (5-D, layer first)")
    if cache_k.dtype == torch.bfloat16 and cache_v.dtype == torch.bfloat16:
        if k_scale is not None or v_scale is not None:
            raise ValueError("a bf16 cache takes no scales")
        return False
    if cache_k.dtype != torch.int8 or cache_v.dtype != torch.int8:
        raise ValueError("cache must be bf16, or int8 codes with scales, "
                         f"not {cache_k.dtype} / {cache_v.dtype}")
    want = tuple(cache_k.shape[:-1])
    for s in (k_scale, v_scale):
        if s is None or s.dtype != torch.float32 or tuple(s.shape) != want \
                or not s.is_contiguous() or s.device != cache_k.device:
            raise ValueError("an int8 cache needs contiguous f32 k_scale and "
                             f"v_scale of shape {want} on {cache_k.device}")
    return True


def _check_cache(q, cache_k, cache_v, k_scale, v_scale, d) -> bool:
    """``_check_storage``, on q's CUDA device, at a head_dim the kernels
    take. Returns whether the cache is int8."""
    int8 = _check_storage(cache_k, cache_v, k_scale, v_scale)
    if not (cache_k.is_cuda and cache_v.is_cuda
            and cache_k.device == q.device == cache_v.device):
        raise ValueError("q and the cache must lie on one CUDA device")
    if d not in (64, 128):
        raise ValueError(f"kernel needs head_dim 64 or 128, got {d}")
    return int8


def _layer_ptr(cache, layer_idx) -> int:
    if not 0 <= int(layer_idx) < cache.shape[0]:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {cache.shape[0]})")
    per_layer = cache[0].numel() * cache.element_size()
    return cache.data_ptr() + int(layer_idx) * per_layer


def _kv_args(kernel, int8, cache_k, cache_v, k_scale, v_scale, layer_idx):
    """(launch counter, C entry point, pointers of one layer's K, V and,
    int8, their scales) for ``kernel``'s bf16 or int8 variant."""
    ptrs = [_layer_ptr(cache_k, layer_idx), _layer_ptr(cache_v, layer_idx)]
    if not int8:
        return kernel, f"tce_{kernel}", ptrs
    ptrs += [_layer_ptr(k_scale, layer_idx), _layer_ptr(v_scale, layer_idx)]
    return f"{kernel}_int8", f"tce_{kernel}_s8", ptrs


def _split_workspace(b: int, hq: int, d: int, n_split: int, device):
    """The decode kernels' f32 scratch: each (row, query head, split)'s
    unnormalised [D] sum, then its (m, l)."""
    return torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                       device=device)


def flash_decode(q, cache_k, cache_v, layer_idx, lengths, k_scale=None,
                 v_scale=None, *, sm_scale: float | None = None,
                 window: int | None = None, ctx_cap: int | None = None
                 ) -> torch.Tensor:
    """Single-step attention: q [B, Hq, D] against the stacked cache
    [L, B, Hkv, S_max, D]; keys at positions < lengths[b] (int or int32
    [B]) take part, and with ``window`` only the last ``window`` of them.
    int8 cache: k_scale/v_scale [L, B, Hkv, S_max] f32. Returns
    [B, Hq, D] in q.dtype. CUDA: ``csrc/flash_decode.cu`` (counter
    ``flash_decode`` or ``flash_decode_int8``), the key range split over
    ``decode_splits(length or S_max)`` blocks a row and merged by a second
    kernel; CPU: ``flash_decode_plain``. ``ctx_cap``: a static bound on
    every device length (the caller's to keep), which cuts the grid to
    ``decode_splits(min(ctx_cap, S_max))``; a host length sizes the grid
    itself, and the plain version needs no bound."""
    if not q.is_cuda:
        return flash_decode_plain(q, cache_k, cache_v, layer_idx, lengths,
                                  k_scale, v_scale, window=window)
    b, hq, d = q.shape
    int8 = _check_cache(q, cache_k, cache_v, k_scale, v_scale, d)
    _, bc, hkv, smax, dc = cache_k.shape
    if bc != b or dc != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(cache_k.shape)} (Hq a multiple of Hkv)")
    len_ptr, len_scalar = _lengths_arg(lengths, b, q.device, smax)
    cap = smax if ctx_cap is None else min(int(ctx_cap), smax)
    n_split = decode_splits(cap if len_ptr is not None else len_scalar)
    qb = q.to(torch.bfloat16).contiguous()
    out = torch.empty_like(qb)
    ws = _split_workspace(b, hq, d, n_split, q.device)
    name, entry, kv = _kv_args("flash_decode", int8, cache_k, cache_v,
                               k_scale, v_scale, layer_idx)
    fn = _build.bind(name, entry, [_P] * (3 + len(kv))
                     + [_I, _I, _I, _I, _I, _P, _I, _I, _F, _I, _P])
    _build.check(fn(qb.data_ptr(), *kv, out.data_ptr(), ws.data_ptr(), b, hq,
                    hkv, smax, d, len_ptr, len_scalar, window or 0,
                    sm_scale or 1.0 / d ** 0.5, n_split,
                    torch.cuda.current_stream(q.device).cuda_stream), name)
    _build.LAUNCHES[name] += 1
    return out.to(q.dtype)


def flash_prefill(q, cache_k, cache_v, layer_idx, start, length,
                  k_scale=None, v_scale=None, *,
                  sm_scale: float | None = None,
                  window: int | None = None) -> torch.Tensor:
    """Causal attention for a prompt chunk q [B, S, Hq, D] at positions
    start..start+S-1 against the stacked cache, which already holds the
    chunk. start/length: int or int32 [B]; length is the valid KV length.
    Key ``col`` is allowed for query position ``qpos`` iff
    col < min(qpos + 1, length) (and col > qpos - window), so rows past the
    true length attend to the whole prefix and never give NaN.
    int8 cache: k_scale/v_scale [L, B, Hkv, S_max] f32. Returns
    [B, S, Hq*D] in q.dtype. CUDA: ``csrc/flash_prefill.cu`` (counter
    ``flash_prefill`` or ``flash_prefill_int8``); CPU:
    ``flash_prefill_plain``."""
    if not q.is_cuda:
        return flash_prefill_plain(q, cache_k, cache_v, layer_idx, start,
                                   length, k_scale, v_scale, window=window)
    b, s, hq, d = q.shape
    int8 = _check_cache(q, cache_k, cache_v, k_scale, v_scale, d)
    _, bc, hkv, smax, dc = cache_k.shape
    if bc != b or dc != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(cache_k.shape)}")
    st_ptr, st_scalar = _lengths_arg(start, b, q.device, smax)
    len_ptr, len_scalar = _lengths_arg(length, b, q.device, smax)
    qb = q.to(torch.bfloat16).contiguous()
    out = torch.empty((b, s, hq * d), dtype=torch.bfloat16, device=q.device)
    name, entry, kv = _kv_args("flash_prefill", int8, cache_k, cache_v,
                               k_scale, v_scale, layer_idx)
    fn = _build.bind(name, entry, [_P] * (2 + len(kv))
                     + [_I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _F, _P])
    _build.check(fn(qb.data_ptr(), *kv, out.data_ptr(), b, s, hq,
                    hkv, smax, d, st_ptr, st_scalar, len_ptr, len_scalar,
                    window or 0, sm_scale or 1.0 / d ** 0.5,
                    torch.cuda.current_stream(q.device).cuda_stream), name)
    _build.LAUNCHES[name] += 1
    return out.to(q.dtype)


def gather_pages(pages_k, pages_v, layer_idx, page_table, k_scale=None,
                 v_scale=None):
    """Each row's pages of one layer as a contiguous [B, Hkv, max_pages * P,
    D] view (int8 dequantized to bf16), as the JAX forward's non-TPU paged
    branch builds it."""
    ids = page_table.long()
    b, mp = ids.shape
    _, _, hkv, p, d = pages_k.shape

    def rows(buf):  # [B, MP, H, P, ...] -> [B, H, MP * P, ...]
        g = buf[layer_idx][ids]
        return g.transpose(1, 2).reshape(b, hkv, mp * p, *g.shape[4:])

    k, v = rows(pages_k), rows(pages_v)
    if k_scale is not None:
        k = (k.float() * rows(k_scale)[..., None]).to(torch.bfloat16)
        v = (v.float() * rows(v_scale)[..., None]).to(torch.bfloat16)
    return k, v


def flash_decode_paged_plain(q, pages_k, pages_v, layer_idx, lengths,
                             page_table, k_scale=None, v_scale=None, *,
                             window: int | None = None) -> torch.Tensor:
    """q [B, Hq, D] at position lengths[b] - 1 against each row's gathered
    pages, with ``attention_xla``'s cast points. A row of length 0 sees
    only masked keys (a uniform average, as in the JAX branch)."""
    b, hq, d = q.shape
    ck, cv = gather_pages(pages_k, pages_v, layer_idx, page_table, k_scale,
                          v_scale)
    ln = _per_batch(lengths, b, q.device)
    out = attention_plain(q[:, None], ck, cv, (ln - 1)[:, None], ln, window)
    return out.reshape(b, hq, d)


def flash_decode_paged(q, pages_k, pages_v, layer_idx, lengths, page_table,
                       k_scale=None, v_scale=None, *,
                       sm_scale: float | None = None,
                       window: int | None = None) -> torch.Tensor:
    """Single-step attention over paged KV storage: q [B, Hq, D]; pages
    [L, n_pages, Hkv, P, D]; page_table [B, max_pages] int32 (entry j of
    row b holds the row's j-th page); lengths int or int32 [B]. Returns
    [B, Hq, D] in q.dtype; int8 pages: k_scale/v_scale [L, n_pages, Hkv, P]
    f32. CUDA: ``csrc/flash_decode_paged.cu`` (counter
    ``flash_decode_paged`` or ``flash_decode_paged_int8``; a row of length
    0 gives zeros), ``flash_decode``'s body and split (grid depth
    ``decode_splits(length or max_pages * P)``), bit-identical to it on the
    same keys; CPU: ``flash_decode_paged_plain``."""
    if not q.is_cuda:
        return flash_decode_paged_plain(q, pages_k, pages_v, layer_idx,
                                        lengths, page_table, k_scale, v_scale,
                                        window=window)
    b, hq, d = q.shape
    int8 = _check_cache(q, pages_k, pages_v, k_scale, v_scale, d)
    _, _, hkv, p, dc = pages_k.shape
    if dc != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(pages_k.shape)} (Hq a multiple of Hkv)")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or page_table.device != q.device \
            or not page_table.is_contiguous():
        raise ValueError("page_table must be a contiguous int32 [B, "
                         f"max_pages] tensor on {q.device}")
    max_pages = page_table.shape[1]
    len_ptr, len_scalar = _lengths_arg(lengths, b, q.device, max_pages * p)
    n_split = decode_splits(max_pages * p if len_ptr is not None
                            else len_scalar)
    qb = q.to(torch.bfloat16).contiguous()
    out = torch.empty_like(qb)
    ws = _split_workspace(b, hq, d, n_split, q.device)
    name, entry, kv = _kv_args("flash_decode_paged", int8, pages_k, pages_v,
                               k_scale, v_scale, layer_idx)
    fn = _build.bind(name, entry, [_P] * (3 + len(kv))
                     + [_I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _F, _I, _P])
    _build.check(fn(qb.data_ptr(), *kv, out.data_ptr(), ws.data_ptr(), b, hq,
                    hkv, p, d, page_table.data_ptr(), max_pages, len_ptr,
                    len_scalar, window or 0, sm_scale or 1.0 / d ** 0.5,
                    n_split,
                    torch.cuda.current_stream(q.device).cuda_stream), name)
    _build.LAUNCHES[name] += 1
    return out.to(q.dtype)


def exact_f32_products(t: torch.Tensor) -> None:
    """The int8 attention products run as fp32 matmuls of int8 codes. They
    are exact while every partial sum is an integer below 2^24: QK sums at
    most 128^2 * D (2.1 M at D = 128), PV at most 128 * (127 + T / 2)
    (148 k at T = 2048 keys, the requanted probabilities summing to at most
    127 + T / 2). On the card that holds only with TF32 off: checked here."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the int8 attention products need TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32 = False)")


def int8_probs(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim (masked keys at NEG_INF), then the x127
    requant: exp(s - max) / max(sum, 1e-30), round half to even, clip to
    int8. Returns the codes as f32."""
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.clamp(torch.round(p * 127.0), -128, 127)


# keys per chunk of int8_decode's split (csrc/int8_decode.cu's CH)
INT8_SPLIT = 64


def int8_splits(cap: int) -> int:
    """``int8_decode``'s chunks for rows of at most ``cap`` keys:
    ceil(cap / INT8_SPLIT), at least 1."""
    return max(1, -(-int(cap) // INT8_SPLIT))


def int8_cluster(n_chunks: int, device_lengths: bool) -> int:
    """The blocks of one ``int8_decode`` row (one thread-block cluster): up
    to 8 when the length is a host int (every block then holds keys), up to
    4 when the lengths live on the device and the grid covers S_max (a
    short row leaves fewer blocks empty: on an H100, 8 short rows in a
    2048-key cache ran 0.0148 ms at 4 and 0.0187 at 8, rows to 2047 keys
    0.0335 and 0.0285). A row's bits do not depend on it."""
    return min(n_chunks, 4 if device_lengths else 8)


def _alpha(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def int8_decode_plain(q_s8, cache_k, cache_v, layer_idx, lengths, qk_alpha,
                      pv_alpha) -> torch.Tensor:
    """The dense Int8OPT dataflow at one query position, restricted to each
    row's valid length: s = (q . k) * qk_alpha, ``int8_probs``, then
    (p_s8 . v) * pv_alpha. Returns f32 [B, H, D]; a row of length 0 gives
    zeros."""
    b, h, d = q_s8.shape
    dev = q_s8.device
    exact_f32_products(q_s8)
    k, v = cache_k[layer_idx], cache_v[layer_idx]  # [B, H, S_max, D] int8
    s = torch.einsum("bhd,bhtd->bht", q_s8.float(), k.float()) \
        * _alpha(qk_alpha, dev)
    ln = _per_batch(lengths, b, dev)[:, None, None]
    col = torch.arange(k.shape[2], device=dev)
    s = torch.where(col[None, None, :] < ln, s, NEG_INF)
    out = torch.einsum("bht,bhtd->bhd", int8_probs(s), v.float()) \
        * _alpha(pv_alpha, dev)
    return torch.where(ln > 0, out, 0.0)


def _alpha_arg(value, device):
    """(device pointer, scalar) for a float or a one-element f32 tensor on
    ``device`` (read by the kernel, so no host sync)."""
    if isinstance(value, torch.Tensor):
        if value.dtype != torch.float32 or value.device != device \
                or value.numel() != 1:
            raise ValueError("an alpha tensor must be one f32 value on "
                             f"{device}")
        return value.data_ptr(), 0.0
    return None, float(value)


def int8_decode(q_s8, cache_k, cache_v, layer_idx, lengths, qk_alpha,
                pv_alpha) -> torch.Tensor:
    """Single-step Int8OPT attention: q_s8 [B, H, D] int8 against the raw
    int8 stacked cache [L, B, H, S_max, D] (no scales: SmoothQuant's static
    scales live in the alphas); keys at positions < lengths[b] (int or
    int32 [B]) take part. qk_alpha / pv_alpha: floats or one-element f32
    tensors. Returns the pre-requant output f32 [B, H, D]. CUDA:
    ``csrc/int8_decode.cu``, ``int8_splits(length or S_max)`` chunks a row
    over one cluster of ``int8_cluster`` blocks; CPU: ``int8_decode_plain``."""
    if not q_s8.is_cuda:
        return int8_decode_plain(q_s8, cache_k, cache_v, layer_idx, lengths,
                                 qk_alpha, pv_alpha)
    b, h, d = q_s8.shape
    if not (cache_k.is_cuda and cache_v.is_cuda
            and cache_k.device == q_s8.device == cache_v.device):
        raise ValueError("q and the cache must lie on one CUDA device")
    if q_s8.dtype != torch.int8 or cache_k.dtype != torch.int8 \
            or cache_v.dtype != torch.int8 \
            or not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("q and the cache must be int8, the cache "
                         "contiguous (5-D, layer first)")
    if cache_k.dim() != 5 or cache_v.shape != cache_k.shape \
            or tuple(cache_k.shape[1:3]) != (b, h) or cache_k.shape[4] != d:
        raise ValueError(f"q {tuple(q_s8.shape)} does not fit cache "
                         f"{tuple(cache_k.shape)}")
    if d not in (64, 128):
        raise ValueError(f"kernel needs head_dim 64 or 128, got {d}")
    smax = cache_k.shape[3]
    len_ptr, len_scalar = _lengths_arg(lengths, b, q_s8.device, smax)
    qk_ptr, qk_scalar = _alpha_arg(qk_alpha, q_s8.device)
    pv_ptr, pv_scalar = _alpha_arg(pv_alpha, q_s8.device)
    n_chunks = int8_splits(smax if len_ptr is not None else len_scalar)
    qc = q_s8.contiguous()
    out = torch.empty((b, h, d), dtype=torch.float32, device=q_s8.device)
    fn = _build.bind("int8_decode", "tce_int8_decode",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _F, _P, _F,
                      _I, _I, _P])
    _build.check(fn(qc.data_ptr(), _layer_ptr(cache_k, layer_idx),
                    _layer_ptr(cache_v, layer_idx), out.data_ptr(), b, h,
                    smax, d, len_ptr, len_scalar, qk_ptr, qk_scalar, pv_ptr,
                    pv_scalar, n_chunks,
                    int8_cluster(n_chunks, len_ptr is not None),
                    torch.cuda.current_stream(q_s8.device).cuda_stream),
                 "int8_decode")
    _build.LAUNCHES["int8_decode"] += 1
    return out
