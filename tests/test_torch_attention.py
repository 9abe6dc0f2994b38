"""The port's attention (plain versions on the CPU) against the JAX
package's flash kernels in interpret mode and its dense ``attention_xla``.
Caches and queries come from numpy with a seed and are fed to both sides."""

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


def _caches(rng, L, B, H, S, D, quantized=False):
    """The same filled cache on both sides (bf16 or int8 + scales)."""
    k, v = _bf16(rng, (B, S, H, D)), _bf16(rng, (B, S, H, D))
    jc = jkvc.init_cache(L, B, S, H, D, quantized=quantized)
    tc = tkvc.init_cache(L, B, S, H, D, quantized=quantized,
                         device="cpu")
    for li in range(L):
        jc = jkvc.update_layer(jc, jnp.asarray(k), jnp.asarray(v), li,
                               jnp.int32(0))
        tkvc.update_layer(tc, _t(k), _t(v), li, 0)
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
    """In-place writes and int8 quantization equal the JAX cache's."""
    rng = np.random.default_rng(4)
    for quantized in (False, True):
        jc, tc = _caches(rng, 2, 1, 2, 64, 64, quantized=quantized)
        k, v = _bf16(rng, (1, 5, 2, 64)), _bf16(rng, (1, 5, 2, 64))
        jc = jkvc.update_layer(jc, jnp.asarray(k), jnp.asarray(v), 1,
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


def test_kernel_wrappers_refuse_int8_on_cuda_only():
    """On the CPU the int8 cache takes the plain path; the CUDA kernels
    take bf16 only, and say so."""
    rng = np.random.default_rng(5)
    _, tc = _caches(rng, 1, 1, 2, 64, 64, quantized=True)
    q = _t(_bf16(rng, (1, 4, 64)))
    out = tatt.flash_decode(q, tc.k, tc.v, 0, 10, tc.k_scale, tc.v_scale)
    assert out.shape == (1, 4, 64) and torch.isfinite(out.float()).all()
    with pytest.raises(NotImplementedError):
        tatt._check_cache(q, tc.k, tc.v, tc.k_scale, 64)


def _kernel_like(q, ck, cv, allowed):
    """The kernels' cast points on the CPU: probabilities exp(s - max)
    rounded to bf16 before PV, their sum l taken unrounded, out = PV / l
    rounded to bf16. q [B, S, Hq, D]; cache layer [B, Hkv, T, D]; allowed
    [S, T] bool. Returns [B, S, Hq, D]."""
    d, g = q.shape[-1], q.shape[2] // ck.shape[1]
    k = ck.float().repeat_interleave(g, 1)
    v = cv.float().repeat_interleave(g, 1)
    s = torch.einsum("bshd,bhtd->bhst", q.float(), k) / d ** 0.5
    s = torch.where(allowed, s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhst,bhtd->bshd", p.to(torch.bfloat16).float(), v)
    return (out / p.sum(-1)[..., None].transpose(1, 2)).to(torch.bfloat16)


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
