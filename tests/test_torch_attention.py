"""The port's attention (plain versions on the CPU) against the JAX
package's flash kernels in interpret mode and its dense ``attention_xla``.
Caches and queries come from numpy with a seed and are fed to both sides."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.ops import attention as jatt
from tinychatengine_tpu_torch.generation import kv_cache as tkvc
from tinychatengine_tpu_torch.ops import attention as tatt
from tinychatengine_tpu_torch.quant.packing import from_bf16_bits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32).astype(
        ml_dtypes.bfloat16)


def _t(a):
    return from_bf16_bits(np.asarray(a).view(np.uint16))


# the JAX cache write as its forwards run it, under jit (the int8 scales'
# division by 127 is then XLA's product by the f32 reciprocal)
_jax_update_layer = jax.jit(jkvc.update_layer)


def _caches(rng, L, B, H, S, D, quantized=False):
    """The same filled cache on both sides (bf16 or int8 + scales): the JAX
    package's cache written by its update_layer, the port's holding the
    same arrays, so the attention tests read identical codes and scales.
    The port's own writes are held to the jitted JAX write by
    ``test_kv_cache_update_matches_jax``."""
    k, v = _bf16(rng, (B, S, H, D)), _bf16(rng, (B, S, H, D))
    jc = jkvc.init_cache(L, B, S, H, D, quantized=quantized)
    for li in range(L):
        jc = jkvc.update_layer(jc, jnp.asarray(k), jnp.asarray(v), li,
                               jnp.int32(0))
    if quantized:
        k_, v_, ks, vs = (torch.from_numpy(np.array(a)) for a in
                          (jc.k, jc.v, jc.k_scale, jc.v_scale))
        tc = tkvc.KVCache(k=k_, v=v_, k_scale=ks, v_scale=vs)
    else:
        tc = tkvc.KVCache(k=_t(jc.k), v=_t(jc.v))
    return jc, tc


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# tolerances: the plain versions normalise the probabilities before the bf16
# cast (attention_xla), the flash kernels after it, so they differ by a few
# bf16 rounding steps of values of order 1 (the JAX tests' own rtol=atol=5e-2)
FLASH_TOL = 5e-2
XLA_TOL = 1e-2  # same formula on both sides: f32 sums in another order


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (8, 2, 128), (4, 4, 64)])
def test_flash_decode_plain_matches_jax(hq, hkv, d):
    rng = np.random.default_rng(0)
    L, B, S = 2, 3, 256
    jc, tc = _caches(rng, L, B, hkv, S, d)
    q = _bf16(rng, (B, hq, d))
    lengths = np.array([1, 77, 256], np.int32)  # ragged
    for li in range(L):
        got = tatt.flash_decode(_t(q), tc.k, tc.v, li, torch.from_numpy(lengths))
        want = jatt.flash_decode(jnp.asarray(q), jc.k, jc.v, jnp.int32(li),
                                 jnp.asarray(lengths), interpret=True,
                                 block_s=128)
        _close(got, want, FLASH_TOL)
        ck, cv = jkvc.read_layer(jc, li)
        xla = jatt.attention_xla(jnp.asarray(q)[:, None], ck, cv,
                                 jnp.asarray(lengths - 1)[:, None],
                                 jnp.asarray(lengths))
        _close(got, np.asarray(xla).reshape(B, hq, d), XLA_TOL)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_decode_plain_window_and_int8(window):
    rng = np.random.default_rng(1)
    L, B, H, S, D = 2, 2, 2, 256, 64
    jc, tc = _caches(rng, L, B, H, S, D, quantized=True)
    q = _bf16(rng, (B, 4, D))
    for length in (3, 200):
        got = tatt.flash_decode(_t(q), tc.k, tc.v, 1, length, tc.k_scale,
                                tc.v_scale, window=window)
        want = jatt.flash_decode(jnp.asarray(q), jc.k, jc.v, jnp.int32(1),
                                 jnp.full((B,), length, jnp.int32),
                                 jc.k_scale, jc.v_scale, window=window,
                                 interpret=True, block_s=128)
        _close(got, want, FLASH_TOL)


@pytest.mark.parametrize("d,start,window", [(64, 0, None), (128, 0, None),
                                            (64, 96, None), (64, 96, 48)])
def test_flash_prefill_plain_matches_jax(d, start, window):
    rng = np.random.default_rng(2)
    L, B, hq, hkv, S = 2, 2, 4, 2, 256
    jc, tc = _caches(rng, L, B, hkv, S, d)
    s_q, true_len = 64, 50  # rows 50..63 are bucket padding
    q = _bf16(rng, (B, s_q, hq, d))
    length = start + true_len
    got = tatt.flash_prefill(_t(q), tc.k, tc.v, 1, start, length,
                             window=window)
    assert not torch.isnan(got).any()
    want = jatt.flash_prefill(jnp.asarray(q), jc.k, jc.v, jnp.int32(1),
                              jnp.int32(start), jnp.int32(length),
                              window=window, interpret=True, block_q=64,
                              block_s=64)
    _close(got, want, FLASH_TOL)
    ck, cv = jkvc.read_layer(jc, 1)
    pos = jnp.broadcast_to(start + jnp.arange(s_q), (B, s_q))
    xla = jatt.attention_xla(jnp.asarray(q), ck, cv, pos, length,
                             window=window)
    _close(got, xla, XLA_TOL)


def test_flash_prefill_plain_ragged_starts():
    rng = np.random.default_rng(3)
    L, B, hq, hkv, S, D = 1, 3, 4, 2, 256, 64
    jc, tc = _caches(rng, L, B, hkv, S, D)
    s_q = 32
    starts = np.array([0, 17, 200], np.int32)
    q = _bf16(rng, (B, s_q, hq, D))
    got = tatt.flash_prefill(_t(q), tc.k, tc.v, 0, torch.from_numpy(starts),
                             torch.from_numpy(starts + s_q))
    want = jatt.flash_prefill(jnp.asarray(q), jc.k, jc.v, jnp.int32(0),
                              jnp.asarray(starts), jnp.asarray(starts + s_q),
                              interpret=True, block_q=32, block_s=64)
    _close(got, want, FLASH_TOL)


def test_kv_cache_update_matches_jax():
    """In-place writes and int8 quantization equal the JAX cache's (its
    write jitted, as the JAX forwards run it)."""
    rng = np.random.default_rng(4)
    for quantized in (False, True):
        jc = jkvc.init_cache(2, 1, 64, 2, 64, quantized=quantized)
        tc = tkvc.init_cache(2, 1, 64, 2, 64, quantized=quantized,
                             device="cpu")
        k, v = _bf16(rng, (1, 64, 2, 64)), _bf16(rng, (1, 64, 2, 64))
        for li in range(2):
            jc = _jax_update_layer(jc, jnp.asarray(k), jnp.asarray(v), li,
                                   jnp.int32(0))
            tkvc.update_layer(tc, _t(k), _t(v), li, 0)
        k, v = _bf16(rng, (1, 5, 2, 64)), _bf16(rng, (1, 5, 2, 64))
        jc = _jax_update_layer(jc, jnp.asarray(k), jnp.asarray(v), 1,
                               jnp.int32(30))
        same = tkvc.update_layer(tc, _t(k), _t(v), 1, 30)
        assert same is tc  # in place
        for a, b in ((tc.k, jc.k), (tc.v, jc.v), (tc.k_scale, jc.k_scale)):
            if b is None:
                assert a is None
            elif a.dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    a.view(torch.int16).numpy(),
                    np.asarray(b).view(np.int16))
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tkvc.advance(tc, 5).length == 5
        for a, b in zip(tkvc.read_layer(tc, 1), jkvc.read_layer(jc, 1)):
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          np.asarray(b).view(np.int16))


def test_kernel_wrappers_check_int8_storage():
    """The kernels take a contiguous bf16 cache with no scales, or int8
    codes with contiguous f32 k_scale and v_scale of the cache's shape
    without D, on the codes' device. The storage checks refuse anything
    else with ValueError, before the device is looked at; on the CPU a
    well-formed int8 cache takes the plain path."""
    rng = np.random.default_rng(5)
    _, tc = _caches(rng, 1, 1, 2, 64, 64, quantized=True)
    q = _t(_bf16(rng, (1, 4, 64)))
    out = tatt.flash_decode(q, tc.k, tc.v, 0, 10, tc.k_scale, tc.v_scale)
    assert out.shape == (1, 4, 64) and torch.isfinite(out.float()).all()
    k, v, ks, vs = tc.k, tc.v, tc.k_scale, tc.v_scale
    bf = k.to(torch.bfloat16)

    def strided(t):  # the same shape and values, not contiguous
        return t.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert tatt._check_storage(k, v, ks, vs) is True
    assert tatt._check_storage(bf, bf, None, None) is False
    bad = {"int8 without scales": (k, v, None, None),
           "one scale missing": (k, v, ks, None),
           "scales of the wrong shape": (k, v, ks[..., :32], vs[..., :32]),
           "scales with a D axis": (k, v, ks[..., None].expand(k.shape),
                                    vs[..., None].expand(k.shape)),
           "bf16 scales": (k, v, ks.to(torch.bfloat16), vs),
           "f64 scales": (k, v, ks, vs.double()),
           "non-contiguous scales": (k, v, strided(ks), vs),
           "non-contiguous codes": (strided(k), v, ks, vs),
           "scales beside a bf16 cache": (bf, bf, ks, vs),
           "int8 K with bf16 V": (k, bf, ks, vs),
           "uint8 codes": (k.view(torch.uint8), v.view(torch.uint8), ks, vs)}
    for name, args in bad.items():
        with pytest.raises(ValueError) as err:
            tatt._check_cache(q, *args, 64)
        assert "CUDA device" not in str(err.value), name
    with pytest.raises(ValueError, match="CUDA device"):  # storage passed
        tatt._check_cache(q, k, v, ks, vs, 64)


def _online(s, v, vs, tile):
    """Online softmax over key tiles of ``tile`` columns of scores s
    [..., T] (masked to -1e30) against v [B, H, T, D]: (m, l, acc), the
    probabilities (times vs, when given) rounded to bf16 before PV."""
    d = v.shape[-1]
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (d,))
    for t0 in range(0, s.shape[-1], tile):
        st = s[..., t0:t0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if vs is not None:
            p = p * vs[..., t0:t0 + tile]
        acc = acc * alpha + torch.einsum(
            "bhst,bhtd->bhsd", p.to(torch.bfloat16).float(),
            v[:, :, t0:t0 + tile])
        m = m_new
    return m, l, acc


def _kernel_like(q, ck, cv, allowed, k_scale=None, v_scale=None, tile=None,
                 split=None):
    """The kernels' cast points on the CPU, an online softmax over key
    tiles of ``tile`` columns (the whole row when None): s = (q . k) *
    sm_scale, and with int8 codes then times k_scale[pos]; the running max
    and sum l over the unscaled probabilities exp(s - max); with int8 the
    probabilities times v_scale[pos]; then rounded to bf16 against the
    (exact) V values, summed in f32; out = PV / l rounded to bf16.
    With ``split`` (the decode kernels' partition), the keys are cut into
    chunks of ``split`` columns from position 0, each chunk runs its own
    online softmax over its tiles, a chunk with no allowed key of a row is
    empty for it, and the chunks are merged in ascending order in f32: M =
    max m over the non-empty chunks, acc = sum acc_i exp(m_i - M), l = sum
    l_i exp(m_i - M), out = acc / l, or zeros where no chunk holds a key.
    q [B, S, Hq, D]; cache layer [B, Hkv, T, D] (bf16, or int8 codes with
    scales [B, Hkv, T]); allowed broadcasts to [B, 1, S, T]. Returns
    [B, S, Hq, D]."""
    d, g = q.shape[-1], q.shape[2] // ck.shape[1]
    k = ck.float().repeat_interleave(g, 1)
    v = cv.float().repeat_interleave(g, 1)
    s = torch.einsum("bshd,bhtd->bhst", q.float(), k) * (1.0 / d ** 0.5)
    vs = None
    if k_scale is not None:
        s = s * k_scale.repeat_interleave(g, 1)[:, :, None]
        vs = v_scale.repeat_interleave(g, 1)[:, :, None]
    s = torch.where(allowed, s, torch.tensor(-1e30))
    n = s.shape[-1]
    tile = tile or n
    if split is None:
        _, l, acc = _online(s, v, vs, tile)
        return (acc / l).transpose(1, 2).to(torch.bfloat16)
    allowed = torch.broadcast_to(allowed, s.shape)
    parts = []
    for c0 in range(0, n, split):
        cut = slice(c0, c0 + split)
        m, l, acc = _online(s[..., cut], v[:, :, cut],
                            None if vs is None else vs[..., cut], tile)
        empty = ~allowed[..., cut].any(-1, keepdim=True)
        parts.append((m, torch.where(empty, 0.0, l), acc))
    m_max = torch.stack([torch.where(l > 0, m, -torch.inf)
                         for m, l, _ in parts]).amax(0)
    acc_t, l_t = 0.0, 0.0
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - m_max), 0.0)
        acc_t, l_t = acc_t + acc * w, l_t + l * w
    out = torch.where(l_t > 0, acc_t / torch.where(l_t > 0, l_t, 1.0), 0.0)
    return out.transpose(1, 2).to(torch.bfloat16)


def _int8_layer(tc, li):
    return tc.k[li], tc.v[li], tc.k_scale[li], tc.v_scale[li]


# the int8 arithmetic against the TPU kernels in interpret mode, over the
# same tiles (the TPU's blocks): only the f32 summation order differs, so
# an output may sit one bf16 step (2^-8 of itself) apart, or a probability
# round to the other side of a bf16 boundary. Held to 2^-8 of the element
# plus 2^-10 of its row's largest value, four times tighter than
# chip_smoke.attn_err
def _int8_err(got, want):
    g = got.float().reshape(-1, got.shape[-1])
    w = torch.from_numpy(np.asarray(want, np.float32)).reshape(g.shape)
    limit = 2.0 ** -8 * w.abs() + 2.0 ** -10 * w.abs().amax(1, keepdim=True)
    return float(((g - w).abs() / limit).max())


@pytest.mark.parametrize("window", [None, 70])
def test_int8_cast_points_match_tpu_decode(window):
    """Decode over an int8 cache: ``_kernel_like`` with the TPU kernel's
    128-key blocks against ``flash_decode`` in interpret mode (GQA 4:1,
    D = 128, ragged lengths)."""
    rng = np.random.default_rng(7)
    L, B, hq, hkv, S, D = 2, 3, 8, 2, 384, 128
    jc, tc = _caches(rng, L, B, hkv, S, D, quantized=True)
    q = _bf16(rng, (B, hq, D))
    lengths = np.array([5, 130, 384], np.int32)
    col = torch.arange(S)
    ln = torch.from_numpy(lengths)[:, None, None, None]
    allowed = col < ln
    if window:
        allowed = allowed & (col >= ln - window)
    want = jatt.flash_decode(jnp.asarray(q), jc.k, jc.v, jnp.int32(1),
                             jnp.asarray(lengths), jc.k_scale, jc.v_scale,
                             window=window, interpret=True, block_s=128)
    ck, cv, ks, vs = _int8_layer(tc, 1)
    got = _kernel_like(_t(q)[:, None], ck, cv, allowed, ks, vs, tile=128)
    assert _int8_err(got[:, 0], want) <= 1.0


def test_int8_cast_points_match_tpu_paged_decode():
    """Paged decode over int8 pages (P = 32, a shuffled table, ragged
    lengths): ``_kernel_like`` over the gathered codes and scales, one
    tile per page, against ``flash_decode_paged`` in interpret mode."""
    rng = np.random.default_rng(8)
    L, B, hq, hkv, P, D, mp = 2, 3, 8, 2, 32, 64, 6
    n_pages = B * mp + 1
    k = rng.integers(-127, 128, (L, n_pages, hkv, P, D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, n_pages, hkv, P, D)).astype(np.int8)
    ks = (rng.random((L, n_pages, hkv, P)) * 0.02 + 0.001).astype(np.float32)
    vs = (rng.random((L, n_pages, hkv, P)) * 0.02 + 0.001).astype(np.float32)
    table = (rng.permutation(B * mp) + 1).astype(np.int32).reshape(B, mp)
    lengths = np.array([1, 33, 192], np.int32)
    q = _bf16(rng, (B, hq, D))
    want = jatt.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(1),
        jnp.asarray(lengths), jnp.asarray(table), jnp.asarray(ks),
        jnp.asarray(vs), interpret=True)
    ids = torch.from_numpy(table).long()

    def rows(a):  # layer 1's [n_pages, H, P, ...] -> [B, H, MP * P, ...]
        g = torch.from_numpy(a)[1][ids]
        return g.transpose(1, 2).reshape(B, hkv, mp * P, *g.shape[4:])
    allowed = torch.arange(mp * P) < torch.from_numpy(lengths)[:, None,
                                                                None, None]
    got = _kernel_like(_t(q)[:, None], rows(k), rows(v), allowed, rows(ks),
                       rows(vs), tile=P)
    assert _int8_err(got[:, 0], want) <= 1.0


def _prefill_cast_points(int8, start, window, seed):
    """``_kernel_like`` over the prefill kernel's 64-key tiles against the
    TPU kernel's ``flash_prefill`` in interpret mode with 64-key blocks: a
    causal prompt chunk of 64 rows, 50 of them real (rows past the true
    length attend to the whole prefix), bf16 or int8 KV, GQA 2:1, D = 64.
    Returns (model, TPU kernel)."""
    rng = np.random.default_rng(seed)
    L, B, hq, hkv, S, D = 1, 2, 4, 2, 320, 64
    jc, tc = _caches(rng, L, B, hkv, S, D, quantized=int8)
    s_q, true_len = 64, 50
    q = _bf16(rng, (B, s_q, hq, D))
    length = start + true_len
    want = jatt.flash_prefill(jnp.asarray(q), jc.k, jc.v, jnp.int32(0),
                              jnp.int32(start), jnp.int32(length),
                              jc.k_scale, jc.v_scale, interpret=True,
                              block_q=64, block_s=64, window=window)
    qpos = start + torch.arange(s_q)[:, None]
    col = torch.arange(S)
    allowed = col < torch.clamp(qpos + 1, max=length)
    if window:
        allowed = allowed & (col > qpos - window)
    if int8:
        ck, cv, ks, vs = _int8_layer(tc, 0)
    else:
        (ck, cv), ks, vs = (tc.k[0], tc.v[0]), None, None
    return _kernel_like(_t(q), ck, cv, allowed, ks, vs, tile=64), want


@pytest.mark.parametrize("start", [0, 192])
def test_int8_cast_points_match_tpu_prefill(start):
    """A causal prompt chunk over the int8 cache, at position 0 and at a
    prefix hit's start = 192 (the cache holding an earlier prefill's
    codes), with and without a 70-key window: the kernel's cast points over
    its 64-key tiles (``_prefill_cast_points``) against ``flash_prefill``
    in interpret mode."""
    for window in (None, 70):
        got, want = _prefill_cast_points(True, start, window, 9 + start)
        assert _int8_err(got, want) <= 1.0, window


@pytest.mark.parametrize("window", [None, 70])
@pytest.mark.parametrize("start", [0, 192])
def test_bf16_cast_points_match_tpu_prefill(start, window):
    """The bf16 twin: the prefill kernel's cast points over its 64-key
    tiles against ``flash_prefill`` in interpret mode, at start 0 and 192,
    with and without a window. The same tiles, so only the f32 sums' order
    differs, which can move an output by one bf16 step: up to 2^-7 of the
    element, past ``_int8_err``'s 2^-8 where the row's values are small
    (one element of 512 rows reads 1.2 of it), so held to ``_split_err``
    (2^-7 of the element plus 2^-9 of the row's largest value)."""
    got, want = _prefill_cast_points(False, start, window, 13 + start)
    assert _split_err(got, want) <= 1.0


def test_attention_tolerance_passes_rounding_and_fails_mask_faults():
    """``chip_smoke.attn_err`` is the limit the CUDA attention kernels are
    held to against their plain versions (chip_smoke.py and
    test_torch_cuda.py). It must pass the kernels' rounding and fail a
    64-key tile left out or a mask one key off, at the main path's widths
    (Hq 32, Hkv 8, D 128) and lengths."""
    import chip_smoke
    rng = np.random.default_rng(6)
    hq, hkv, t = 32, 8, 2048
    for d in (64, 128):
        ck = _t(_bf16(rng, (1, hkv, t, d)))
        cv = _t(_bf16(rng, (1, hkv, t, d)))
        col = torch.arange(t)
        for length in (65, 2047):  # decode: one query at length - 1
            q = _t(_bf16(rng, (1, 1, hq, d)))
            want = tatt.flash_decode_plain(q[:, 0], ck[None], cv[None], 0,
                                           length)
            faults = {"exact": col < length, "one key more": col < length + 1,
                      "one key less": col < length - 1}
            if length > 1024:
                faults["tile 1024-1087 left out"] = (col < length) & (
                    (col < 1024) | (col >= 1088))
            for name, allowed in faults.items():
                got = _kernel_like(q, ck, cv, allowed[None])[:, 0]
                share = chip_smoke.attn_err(got, want, d)[1]
                assert (share <= 1.0) == (name == "exact"), (d, length, name,
                                                              share)
        s_q, start = 256, 64  # prefill rows at positions 64..319
        q = _t(_bf16(rng, (1, s_q, hq, d)))
        want = tatt.flash_prefill_plain(q, ck[None], cv[None], 0, start,
                                        start + s_q)
        pos = start + torch.arange(s_q)[:, None]
        for name, allowed in {"exact": col <= pos, "diagonal left out":
                              col < pos, "one key past": col <= pos + 1}.items():
            share = chip_smoke.attn_err(_kernel_like(q, ck, cv, allowed),
                                        want, d)[1]
            assert (share <= 1.0) == (name == "exact"), (d, name, share)


SPLIT = tatt.DECODE_SPLIT
# a ragged batch about the decode split's edges; the row of length 0 gives
# zeros (the JAX kernels leave it undefined: it is held apart)
SPLIT_LENGTHS = np.array([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 65],
                         np.int32)


# The split's chunks and 64-key tiles round the probabilities against other
# running maxima than the TPU kernel's 128-key blocks, so a probability may
# sit one bf16 step apart (the unsplit model over 64-key tiles already
# takes 1.6 of _int8_err's limit, which holds identical tiles to 0.0).
# Held to twice that limit, 2^-7 of the element plus 2^-9 of its row's
# largest value: half chip_smoke.attn_err's, and a tile left out or a key
# too many moves rows far past it
def _split_err(got, want):
    return _int8_err(got, want) / 2


def _split_model(q, k, v, ks, vs, lengths, window):
    """``_kernel_like`` with the decode kernels' split and 64-key tiles,
    over one layer [B, Hkv, T, D] with per-row lengths."""
    col = torch.arange(k.shape[2])
    ln = torch.from_numpy(lengths)[:, None, None, None]
    allowed = col < ln
    if window:
        allowed = allowed & (col >= ln - window)
    return _kernel_like(q[:, None], k, v, allowed, ks, vs, tile=64,
                        split=SPLIT)[:, 0]


@pytest.mark.parametrize("window", [None, 70])
@pytest.mark.parametrize("int8", [False, True])
def test_split_decode_matches_tpu_decode(int8, window):
    """The split decode's cast points (``_kernel_like`` with the split
    partition) against ``flash_decode`` in interpret mode (GQA 4:1,
    D = 128), lengths about the split's edges, bf16 and int8, with and
    without a window; held to ``_split_err``."""
    rng = np.random.default_rng(20 + int8)
    L, B, hq, hkv, S, D = 2, len(SPLIT_LENGTHS), 8, 2, 384, 128
    jc, tc = _caches(rng, L, B, hkv, S, D, quantized=int8)
    q = _bf16(rng, (B, hq, D))
    want = jatt.flash_decode(jnp.asarray(q), jc.k, jc.v, jnp.int32(1),
                             jnp.asarray(SPLIT_LENGTHS), jc.k_scale,
                             jc.v_scale, window=window, interpret=True,
                             block_s=128)
    if int8:
        k, v, ks, vs = _int8_layer(tc, 1)
    else:
        (k, v), ks, vs = (tc.k[1], tc.v[1]), None, None
    got = _split_model(_t(q), k, v, ks, vs, SPLIT_LENGTHS, window)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert _split_err(got[1:], np.asarray(want)[1:]) <= 1.0


@pytest.mark.parametrize("window", [None, 70])
@pytest.mark.parametrize("int8", [False, True])
def test_split_decode_matches_tpu_paged_decode(int8, window):
    """The same split model over pages (P = 32, a shuffled table) against
    ``flash_decode_paged`` in interpret mode: the partition counts key
    positions, not pages, so the model is the dense one over the gathered
    rows."""
    rng = np.random.default_rng(30 + int8)
    L, B, hq, hkv, P, D, mp = 2, len(SPLIT_LENGTHS), 8, 2, 32, 64, 11
    n_pages = B * mp + 1
    if int8:
        k, v = (rng.integers(-127, 128, (L, n_pages, hkv, P, D)).astype(
            np.int8) for _ in range(2))
        ks, vs = ((rng.random((L, n_pages, hkv, P)) * 0.02 + 0.001).astype(
            np.float32) for _ in range(2))
    else:
        k, v = (_bf16(rng, (L, n_pages, hkv, P, D)) for _ in range(2))
        ks = vs = None
    table = (rng.permutation(B * mp) + 1).astype(np.int32).reshape(B, mp)
    q = _bf16(rng, (B, hq, D))
    opt = (lambda a: None if a is None else jnp.asarray(a))
    want = jatt.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(1),
        jnp.asarray(SPLIT_LENGTHS), jnp.asarray(table), opt(ks), opt(vs),
        window=window, interpret=True)
    ids = torch.from_numpy(table).long()

    def rows(a):  # layer 1's [n_pages, H, P, ...] -> [B, H, MP * P, ...]
        if a is None:
            return None
        t = _t(a) if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a)
        g = t[1][ids]
        return g.transpose(1, 2).reshape(B, hkv, mp * P, *g.shape[4:])
    got = _split_model(_t(q), rows(k), rows(v), rows(ks), rows(vs),
                       SPLIT_LENGTHS, window)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert _split_err(got[1:], np.asarray(want)[1:]) <= 1.0


def _partition(length, window, n_split):
    """The (split, begin, end) key ranges that the decode kernels'
    non-empty split blocks visit for a row of ``length`` keys in a grid of
    ``n_split`` splits (``csrc/flash_decode.cuh``): chunks of SPLIT keys
    counted from position 0, cut to lo <= pos < length with lo =
    max(length - window, 0) under a sliding window."""
    lo = max(length - window, 0) if window else 0
    chunks = []
    for z in range(n_split):
        begin, end = max(z * SPLIT, lo), min((z + 1) * SPLIT, length)
        if begin < end:
            chunks.append((z, begin, end))
    return chunks


@pytest.mark.parametrize("window", [None, 70, 300])
def test_decode_partition_depends_on_key_position_only(window):
    """The chunks a row's split blocks visit are the same whether the
    length comes as an int (the wrapper's grid of ``decode_splits(length)``
    splits) or in a [B] tensor (``decode_splits(S)`` dense,
    ``decode_splits(max_pages * P)`` paged): chunks of SPLIT keys from
    position 0, cut to [lo, length) and covering it exactly."""
    S, P, max_pages = 4608, 16, 290  # max_pages * P = 4640
    for n in (0, 1, 63, 64, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 65,
              2047, 4095, S):
        scalar = _partition(n, window, tatt.decode_splits(n))
        assert scalar == _partition(n, window, tatt.decode_splits(S))
        assert scalar == _partition(n, window,
                                    tatt.decode_splits(max_pages * P))
        lo = max(n - window, 0) if window else 0
        keys = [pos for _, b, e in scalar for pos in range(b, e)]
        assert keys == list(range(lo, n))
        for z, b, e in scalar:
            assert z * SPLIT <= b < e <= (z + 1) * SPLIT
    assert tatt.decode_splits(0) == 1  # one empty split: zeros
