"""The port's paged KV cache, paged decode attention (plain version on the
CPU), ragged KV writes and the per-row llama forward against the JAX
package. Pages, caches, queries and weights come from numpy with a seed and
are fed to both sides; the port gets them through ``paged_cache_from_numpy``
and ``params_from_numpy``."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.ops import attention as jatt
from tinychatengine_tpu.runtime import paged as jpg
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.generation import kv_cache as tkvc
from tinychatengine_tpu_torch.models import llama as tllama
from tinychatengine_tpu_torch.ops import attention as tatt
from tinychatengine_tpu_torch.quant.packing import from_bf16_bits
from tinychatengine_tpu_torch.runtime import paged as tpg


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


def _same(got, want):
    """Bit-exact leaf comparison (bf16 through its bits)."""
    if got is None or want is None:
        assert got is None and want is None
        return
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def _pools(rng, L, n_pages, H, P, D, quantized=False):
    """One random page pool as JAX arrays and as the port's cache."""
    shape = (L, n_pages, H, P, D)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:-1]) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random(shape[:-1]) * 0.02 + 0.001).astype(np.float32)
    else:
        k, v = _bf16(rng, shape), _bf16(rng, shape)
        ks = vs = None
    jc = jpg.PagedKVCache(*(None if a is None else jnp.asarray(a)
                            for a in (k, v, ks, vs)))
    tc = tpg.paged_cache_from_numpy(k, v, ks, vs, device="cpu")
    return jc, tc


# the plain version normalises the probabilities before their bf16 cast
# (attention_xla), the Pallas kernel after it: outputs of order 0.1-1
# differ by one bf16 step relative (2^-7) plus a few bf16 steps of the
# probabilities times |v| (the stated atol)
PAGED_RTOL, PAGED_ATOL = 2.0 ** -7, 2e-2
XLA_TOL = 1e-2  # same formula on both sides: f32 sums in another order


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("p,window,quantized", [
    (64, None, False), (16, None, False), (64, 64, False), (64, 100, False),
    (16, 256, False), (64, None, True), (16, 100, True)])
def test_paged_decode_plain_matches_jax(p, window, quantized):
    """Ragged lengths over an interleaved page table (tests/test_paged.py's
    cases), against JAX ``flash_decode_paged`` in interpret mode and its
    non-TPU branch (gathered pages through ``attention_xla``)."""
    rng = np.random.default_rng(p + (window or 0) + quantized)
    L, H, D, hq, B = 2, 2, 128, 8, 3
    max_pages = -(-256 // p)
    n_pages = B * max_pages
    table = rng.permutation(n_pages).reshape(B, max_pages).astype(np.int32)
    lengths = np.array([200, 64, 37], np.int32)
    jc, tc = _pools(rng, L, n_pages, H, p, D, quantized)
    q = _bf16(rng, (B, hq, D))
    got = tatt.flash_decode_paged(
        _t(q), tc.k, tc.v, L - 1, torch.from_numpy(lengths),
        torch.from_numpy(table), tc.k_scale, tc.v_scale, window=window)
    want = jatt.flash_decode_paged(
        jnp.asarray(q), jc.k, jc.v, jnp.int32(L - 1), jnp.asarray(lengths),
        jnp.asarray(table), jc.k_scale, jc.v_scale, window=window,
        interpret=True)
    _close(got, want, PAGED_RTOL, PAGED_ATOL)
    for b in range(B):  # the JAX forward's gathered oracle, row by row
        ck, cv = jpg.gather_contiguous(jc, table[b], L - 1)
        ln = int(lengths[b])
        xla = jatt.attention_xla(jnp.asarray(q)[b:b + 1, None], ck[None],
                                 cv[None], jnp.full((1, 1), ln - 1), ln,
                                 window=window)
        _close(got[b], np.asarray(xla).reshape(hq, D), XLA_TOL, XLA_TOL)


def test_allocator_alloc_free_cycle():
    a = tpg.PageAllocator(n_pages=10, page_size=64, max_pages_per_seq=4)
    p1 = a.alloc(3)
    p2 = a.alloc(4)
    assert len(set(p1) | set(p2)) == 7 and a.n_free == 3
    a.free(p1)
    assert a.n_free == 6
    with pytest.raises(MemoryError):
        a.alloc(7)
    assert a.pages_needed(1) == 1 and a.pages_needed(65) == 2


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_writes_match_jax_leaf_by_leaf(quantized):
    """insert_prefix, then token-by-token paged_update_layer across a page
    boundary (inactive rows on one dead page): every leaf bit-equal to the
    JAX pool's (its writes jitted, as its ServingEngine runs them);
    gather_contiguous gives the same view."""
    rng = np.random.default_rng(7 + quantized)
    L, H, P, D, B = 2, 2, 16, 64, 3
    jc = jpg.init_paged_cache(L, 8, H, P, D, quantized=quantized)
    tc = tpg.init_paged_cache(L, 8, H, P, D, quantized=quantized,
                              device="cpu")
    ids = np.array([5, 2], np.int32)
    if quantized:  # a scratch prefix as the int8 kv cache stores it
        sk = rng.integers(-127, 128, (L, H, 2 * P, D)).astype(np.int8)
        sv = rng.integers(-127, 128, (L, H, 2 * P, D)).astype(np.int8)
        sks = rng.random((L, H, 2 * P)).astype(np.float32)
        svs = rng.random((L, H, 2 * P)).astype(np.float32)
        tsk, tsv = torch.from_numpy(sk), torch.from_numpy(sv)
        tsks, tsvs = torch.from_numpy(sks), torch.from_numpy(svs)
    else:
        sk, sv = _bf16(rng, (L, H, 2 * P, D)), _bf16(rng, (L, H, 2 * P, D))
        sks = svs = tsks = tsvs = None
        tsk, tsv = _t(sk), _t(sv)
    jc = jpg.insert_prefix(jc, jnp.asarray(sk), jnp.asarray(sv),
                           jnp.asarray(ids),
                           None if sks is None else jnp.asarray(sks),
                           None if svs is None else jnp.asarray(svs))
    assert tpg.insert_prefix(tc, tsk, tsv, torch.from_numpy(ids), tsks,
                             tsvs) is tc  # in place
    # row 0 grows from 14 across the page boundary; rows 1-2 are dead
    table = np.array([[5, 2, 7], [0, 0, 0], [0, 0, 0]], np.int32)
    for t in range(4):
        lengths = np.array([14 + t, 0, 0], np.int32)
        k, v = _bf16(rng, (B, 1, H, D)), _bf16(rng, (B, 1, H, D))
        k[1:] = k[1]  # dead rows write the same value to the dead page
        v[1:] = v[1]
        layer = t % L
        jc = jax.jit(jpg.paged_update_layer)(
            jc, jnp.asarray(k), jnp.asarray(v), jnp.int32(layer),
            jnp.asarray(lengths), jnp.asarray(table))
        tpg.paged_update_layer(tc, _t(k), _t(v), layer,
                               torch.from_numpy(lengths),
                               torch.from_numpy(table))
    for got, want in ((tc.k, jc.k), (tc.v, jc.v), (tc.k_scale, jc.k_scale),
                      (tc.v_scale, jc.v_scale)):
        _same(got, want)
    for got, want in zip(tpg.gather_contiguous(tc, table[0], 1),
                         jpg.gather_contiguous(jc, table[0], 1)):
        _same(got, want)


@pytest.mark.parametrize("quantized", [False, True])
def test_ragged_kv_update_matches_jax(quantized):
    """update_layer with a [B] start (decode S = 1 and a ragged chunk)
    equals JAX's ``_update_layer_per_slot`` (jitted, as its forwards run
    it) bit for bit, in place; a
    ragged chunk's positions past max_len are dropped."""
    rng = np.random.default_rng(3)
    L, B, H, S, D = 2, 3, 2, 32, 64
    jc = jkvc.init_cache(L, B, S, H, D, quantized=quantized)
    tc = tkvc.init_cache(L, B, S, H, D, quantized=quantized, device="cpu")
    for s_new, starts in ((1, [0, 9, 31]), (5, [2, 20, 11])):
        k, v = _bf16(rng, (B, s_new, H, D)), _bf16(rng, (B, s_new, H, D))
        st = np.array(starts, np.int32)
        jc = jax.jit(jkvc.update_layer)(jc, jnp.asarray(k), jnp.asarray(v),
                                        1, jnp.asarray(st))
        assert tkvc.update_layer(tc, _t(k), _t(v), 1,
                                 torch.from_numpy(st)) is tc
        for got, want in ((tc.k, jc.k), (tc.v, jc.v),
                          (tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
            _same(got, want)
    before = tc.k.clone()
    k = _bf16(rng, (B, 4, H, D))
    tkvc.update_layer(tc, _t(k), _t(k), 0,
                      torch.tensor([30, 0, 40], dtype=torch.int32))
    kept = _t(k)[0, :2]  # row 0: positions 30, 31 land, 32, 33 drop
    if quantized:
        kept = tkvc._quantize_kv(kept)[0]
    assert torch.equal(tc.k[0, 0, :, 30:32], kept.transpose(0, 1))
    assert torch.equal(tc.k[0, 2], before[0, 2])  # row 2 lies past the end


TINY = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
            num_layers=2, max_sqlen=128, embed_dim=256, hidden_dim=512,
            vocab_size=300)


def _models(scheme):
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jp = jllama.init_random_params(jcfg, JQuantConfig(scheme=scheme), seed=4)
    tp = tllama.params_from_numpy(jckpt._flatten(jp)[0], cfg,
                                  QuantConfig(scheme=scheme), device="cpu")
    return jcfg, cfg, jp, tp


# logits of a 2-layer model, as in test_torch_llama.py: a few bf16 steps of
# logits of order 1 (W4A8 adds an int8 code flip now and then)
@pytest.mark.parametrize("scheme,tol", [("fp", 2e-2), ("w4a8", 4e-2)])
def test_ragged_forward_matches_jax(scheme, tol):
    """A batched admission's forward (ragged true_len, [B] start of zeros)
    and then per-row decode steps ([B] start) against the JAX forward."""
    jcfg, cfg, jp, tp = _models(scheme)
    B, bucket = 3, 16
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 300, (B, bucket))
    true_len = np.array([16, 3, 11], np.int32)
    jc = jkvc.init_cache(2, B, 64, 2, 64)
    tc = tkvc.init_cache(2, B, 64, 2, 64, device="cpu")
    jl, jc = jllama.forward(jp, jcfg, jnp.asarray(ids), jc,
                            jnp.zeros((B,), jnp.int32),
                            true_len=jnp.asarray(true_len))
    tl, tc = tllama.forward(tp, cfg, torch.from_numpy(ids), tc,
                            torch.zeros((B,), dtype=torch.int32),
                            true_len=true_len)
    assert tl.shape == (B, 300) and tc.length == 16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)
    lengths = true_len.copy()
    for _ in range(3):
        tok = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jl, jc = jllama.forward(jp, jcfg, jnp.asarray(tok), jc,
                                jnp.asarray(lengths))
        tl, tc = tllama.forward(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol)
        lengths += 1


def test_paged_forward_matches_jax():
    """Decode steps through a page table (paged_update_layer and
    flash_decode_paged) against the JAX forward's non-TPU paged branch,
    with one dead row on the dead page; and against the port's own dense
    decode of the same sequences."""
    jcfg, cfg, jp, tp = _models("fp")
    rng = np.random.default_rng(6)
    P, B = 16, 3
    prompts = [rng.integers(0, 300, n) for n in (20, 5)]
    jpc = jpg.init_paged_cache(2, 8, 2, P, 64)
    tpc = tpg.init_paged_cache(2, 8, 2, P, 64, device="cpu")
    dense = tkvc.init_cache(2, B, 64, 2, 64, device="cpu")
    table = np.zeros((B, 4), np.int32)  # page 0: the dead page
    table[0, :2], table[1, :1] = [3, 6], [1]
    for r, prompt in enumerate(prompts):  # prefill each into its pages
        n = len(prompt)
        bucket = 32 if n > 16 else 16
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = prompt
        jsc = jkvc.init_cache(2, 1, 64, 2, 64)
        _, jsc = jllama.forward(jp, jcfg, jnp.asarray(ids), jsc, jnp.int32(0),
                                true_len=jnp.int32(n))
        npg = bucket // P
        jpc = jpg.insert_prefix(jpc, jsc.k[:, 0, :, :bucket],
                                jsc.v[:, 0, :, :bucket],
                                jnp.asarray(table[r, :npg]))
        tsc = tkvc.init_cache(2, 1, 64, 2, 64, device="cpu")
        tllama.forward(tp, cfg, torch.from_numpy(ids), tsc, 0, true_len=n)
        tpg.insert_prefix(tpc, tsc.k[:, 0, :, :bucket], tsc.v[:, 0, :, :bucket],
                          torch.from_numpy(table[r, :npg]))
        dense.k[:, r, :, :bucket] = tsc.k[:, 0, :, :bucket]
        dense.v[:, r, :, :bucket] = tsc.v[:, 0, :, :bucket]
    lengths = np.array([20, 5, 0], np.int32)
    tok = np.array([[7], [8], [0]])
    for _ in range(3):
        jl, jpc = jllama.forward(jp, jcfg, jnp.asarray(tok), jpc,
                                 jnp.asarray(lengths),
                                 page_table=jnp.asarray(table))
        tl, _ = tllama.forward(tp, cfg, torch.from_numpy(tok), tpc,
                               torch.from_numpy(lengths),
                               page_table=torch.from_numpy(table))
        dl, _ = tllama.forward(tp, cfg, torch.from_numpy(tok), dense,
                               torch.from_numpy(lengths))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   atol=2e-2, rtol=2e-2)
        assert torch.equal(tl[:2], dl[:2])  # same keys, same plain math
        tok = np.argmax(np.asarray(jl), axis=-1)[:, None]
        tok[2] = 0
        lengths[:2] += 1
