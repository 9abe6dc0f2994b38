"""The port's sequence-parallel ring prefill against the JAX package's
(twins of ``tests/test_sp.py``): ring attention, the SP (x TP) prefill,
its cache and the decode step from the spliced cache, held to the JAX
ring on the 8-device virtual CPU mesh and to the single-device oracle
within JAX's own limits (2e-2; 5e-2 at 16k). One world of 8 ranks runs
every case once per module (``torch_ranks``)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_ranks
from test_torch_parallel import TINY, TOL, flat, jcache, jparams
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.ops.attention import attention_xla, ring_attention
from tinychatengine_tpu.parallel.sharding import shard_params as jshard
from tinychatengine_tpu.parallel.sp import make_sp_mesh as jmake_sp_mesh
from tinychatengine_tpu.parallel.sp import make_sp_prefill as jmake_sp
from tinychatengine_tpu.parallel.sp import shard_sp_cache as jshard_sp
from tinychatengine_tpu.parallel.sp import sp_cache_into as jsp_into

WIN = dict(TINY, name="tiny-win", sliding_window=6)
SP_CASES = [("fp", 4, 1), ("fp", 2, 2), ("w4a16", 4, 1), ("w4a16", 2, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers (and this module's ranks beside
    them): one intra-op thread keeps torch's CPU ops from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


@functools.cache
def _jfwd():
    return jax.jit(jllama.forward,
                   static_argnames=("cfg", "full_logits"))


@functools.cache
def _jsp_fn(n_seq, n_model):
    mesh = jmake_sp_mesh(n_seq, n_model)
    return mesh, jax.jit(jmake_sp(mesh),
                         static_argnames=("cfg", "full_logits"))


def _jsp(params, ids, n_seq, n_model=1, cfg=TINY, **kw):
    """JAX's SP prefill: (logits, its cache)."""
    mesh, fn = _jsp_fn(n_seq, n_model)
    b, s = ids.shape
    c = JModelConfig(**cfg)
    cache = jshard_sp(jkvc.init_cache(c.num_layers, b, s, c.num_kv_heads,
                                      c.head_dim), mesh)
    return fn(jshard(params, mesh), c, jnp.asarray(ids), cache, **kw)


@functools.cache
def _oracle(scheme):
    """The single-device prefill of SP_CASES' prompt, its cache, its greedy
    token [B, 1] and the decode step's logits."""
    cfg = JModelConfig(**TINY)
    fwd = _jfwd()
    l1, c1 = fwd(jparams(scheme, 0), cfg, jnp.asarray(_ids(1, 2, 16)),
                 jcache(batch=2), jnp.int32(0))
    tok = jnp.argmax(l1, -1).astype(jnp.int32)[:, None]
    l1d, _ = fwd(jparams(scheme, 0), cfg, tok, c1, jnp.int32(16))
    return l1, c1, tok, l1d


def _ring_inputs(shape, dtype, seed):
    b, s, hq, hkv, d = shape
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(kq, (b, s, hq, d), dtype)
    k = jax.random.normal(kk, (b, s, hkv, d), dtype)
    v = jax.random.normal(kv, (b, s, hkv, d), dtype)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    return q, k, v, pos


def _torch(a):
    from tinychatengine_tpu_torch.quant.packing import numpy_to_torch
    return numpy_to_torch(np.asarray(a))


def _jring(q, k, v, pos, n_seq, window=None):
    f = shard_map(
        lambda q, k, v, p: ring_attention(q, k, v, p, "seq", window=window),
        mesh=jmake_sp_mesh(n_seq),
        in_specs=(P(None, "seq", None, None), P(None, "seq", None, None),
                  P(None, "seq", None, None), P(None, "seq")),
        out_specs=P(None, "seq", None), check_vma=False)
    return np.asarray(jax.jit(f)(q, k, v, pos)).astype(np.float32)


def _jobs():
    data, jobs = {}, []
    for window in (None, 8):
        q, k, v, pos = _ring_inputs((2, 32, 4, 2, 16), jnp.float32, 0)
        data[f"ring-{window}"] = dict(q=_torch(q), k=_torch(k), v=_torch(v),
                                      pos=_torch(pos), n_seq=4,
                                      window=window)
        jobs.append((f"ring-{window}", "ring"))
    q, k, v, pos = _ring_inputs((1, 16384, 2, 1, 64), jnp.bfloat16, 7)
    data["ring-16k"] = dict(q=_torch(q), k=_torch(k), v=_torch(v),
                            pos=_torch(pos), n_seq=8, window=None)
    jobs.append(("ring-16k", "ring"))
    for scheme, n_seq, n_model in SP_CASES:
        key = f"sp-{scheme}-{n_seq}-{n_model}"
        data[key] = dict(cfg=TINY, qcfg=dict(scheme=scheme), n_seq=n_seq,
                         n_model=n_model, ids=_ids(1, 2, 16),
                         flat=flat(jparams(scheme, 0, n_model)),
                         flat1=flat(jparams(scheme, 0)),
                         decode_tok=np.asarray(_oracle(scheme)[2]))
        jobs.append((key, "sp_prefill"))
    data["padded"] = dict(cfg=TINY, n_seq=4, n_model=1, ids=_ids(2, 1, 16),
                          true_len=11, flat=flat(jparams("fp", 0)))
    data["window"] = dict(cfg=WIN, n_seq=4, n_model=1, ids=_ids(3, 1, 24),
                          flat=flat(jparams("fp", 3, cfg=WIN)))
    data["full"] = dict(cfg=TINY, n_seq=4, n_model=1, ids=_ids(4, 1, 16),
                        full_logits=True, flat=flat(jparams("fp", 0)))
    data["structure"] = dict(cfg=TINY, n_seq=4, n_model=2,
                             ids=np.zeros((1, 16), np.int32),
                             flat=flat(jparams("fp", 0, 2)))
    jobs += [(k, "sp_prefill") for k in ("padded", "window", "full",
                                         "structure")]
    return data, jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data, jobs = _jobs()
    launch = torch_ranks.world(tmp_path_factory.mktemp("sp"), data, jobs, 8)
    cached = []

    def results():
        if not cached:
            cached.append(launch.result())
        return cached[0]
    yield results
    results()


@pytest.mark.parametrize("window", [None, 8])
def test_ring_attention_matches_oracle(ranks, window):
    q, k, v, pos = _ring_inputs((2, 32, 4, 2, 16), jnp.float32, 0)
    oracle = np.asarray(attention_xla(q, k.transpose(0, 2, 1, 3),
                                      v.transpose(0, 2, 1, 3), pos, 32,
                                      window=window))
    ring = _jring(q, k, v, pos, 4, window)
    res = ranks()
    got = res[0][f"ring-{window}"]
    np.testing.assert_allclose(got["out"], ring, **TOL)
    np.testing.assert_allclose(got["out"], oracle, **TOL)
    # n - 1 hops of (k, v, positions)
    assert all(r[f"ring-{window}"]["permutes"] == 9 for r in res[:4])


@pytest.mark.parametrize("scheme,n_seq,n_model", SP_CASES)
def test_sp_prefill_matches_single_device(ranks, scheme, n_seq, n_model):
    """SP (x TP) prefill: last-token logits, the cache, and a decode step
    from the spliced single-device cache, against the oracle and JAX's SP
    prefill."""
    cfg = JModelConfig(**TINY)
    ids = _ids(1, 2, 16)
    fwd = _jfwd()
    l1, c1, tok, l1d = _oracle(scheme)
    ln, cn = _jsp(jparams(scheme, 0, n_model), ids, n_seq, n_model)
    lnd, _ = fwd(jparams(scheme, 0), cfg, tok,
                 jax.jit(jsp_into)(jcache(batch=2), cn), jnp.int32(16))
    got = ranks()[0][f"sp-{scheme}-{n_seq}-{n_model}"]
    for want in (l1, ln):
        np.testing.assert_allclose(got["logits"], np.asarray(want), **TOL)
    assert got["length"] == 16
    # the cache: JAX's limit against JAX's SP cache; against the oracle's,
    # which JAX's SP cache meets within that limit itself, their sum (a
    # layer-1 value carries a few bf16 steps of the 4-way reductions)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            got[name], np.asarray(getattr(cn, name)).astype(np.float32), **TOL)
        np.testing.assert_allclose(
            got[name], np.asarray(getattr(c1, name)[:, :, :, :16])
            .astype(np.float32), rtol=2 * TOL["rtol"], atol=2 * TOL["atol"])
    for want in (l1d, lnd):
        np.testing.assert_allclose(got["decode"], np.asarray(want), **TOL)
    assert (np.argmax(got["decode"], -1) == np.argmax(np.asarray(l1d),
                                                      -1)).all()


def test_sp_prefill_padded_bucket(ranks):
    """A right-padded bucket: true_len picks the owner rank's last real
    token; pads stay beyond the length."""
    cfg = JModelConfig(**TINY)
    ids = _ids(2, 1, 16)
    l1, c1 = _jfwd()(jparams("fp", 0), cfg, jnp.asarray(ids), jcache(),
                     jnp.int32(0), true_len=jnp.int32(11))
    ln, cn = _jsp(jparams("fp", 0), ids, 4, true_len=jnp.int32(11))
    got = ranks()[0]["padded"]
    for want in (l1, ln):
        np.testing.assert_allclose(got["logits"], np.asarray(want), **TOL)
    assert got["length"] == int(cn.length) == 11
    for want in (c1.k, cn.k):
        np.testing.assert_allclose(
            got["k"][:, :, :, :11],
            np.asarray(want[:, :, :, :11]).astype(np.float32), **TOL)


def test_sp_prefill_sliding_window(ranks):
    cfg = JModelConfig(**WIN)
    ids = _ids(3, 1, 24)
    l1, _ = _jfwd()(jparams("fp", 3, cfg=WIN), cfg, jnp.asarray(ids),
                    jcache(WIN), jnp.int32(0))
    ln, _ = _jsp(jparams("fp", 3, cfg=WIN), ids, 4, cfg=WIN)
    got = ranks()[0]["window"]["logits"]
    for want in (l1, ln):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_sp_full_logits(ranks):
    """full_logits gives [B, S, V] gathered over seq (no owner sum)."""
    cfg = JModelConfig(**TINY)
    ids = _ids(4, 1, 16)
    want1, _ = _jfwd()(jparams("fp", 0), cfg, jnp.asarray(ids), jcache(),
                       jnp.int32(0), full_logits=True)
    wantn, _ = _jsp(jparams("fp", 0), ids, 4, full_logits=True)
    res = ranks()
    got = res[0]["full"]
    assert got["logits"].shape == (1, 16, 512)
    for want in (want1, wantn):
        np.testing.assert_allclose(got["logits"], np.asarray(want), **TOL)
    assert got["stats"]["all_reduce"] == 0  # no owner sum


def test_ring_attention_16k_blocked(ranks):
    """A 16k prompt over 8 ranks, tile by tile: against JAX's ring and the
    oracle per 2048-query chunk."""
    q, k, v, pos = _ring_inputs((1, 16384, 2, 1, 64), jnp.bfloat16, 7)
    got = ranks()[0]["ring-16k"]["out"]
    np.testing.assert_allclose(got, _jring(q, k, v, pos, 8), rtol=5e-2,
                               atol=5e-2)
    kt, vt = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    oracle = jax.jit(attention_xla)
    for q0 in range(0, 16384, 2048):
        want = np.asarray(oracle(q[:, q0:q0 + 2048], kt, vt,
                                 pos[:, q0:q0 + 2048], jnp.int32(16384)))
        np.testing.assert_allclose(got[:, q0:q0 + 2048],
                                   want.astype(np.float32), rtol=5e-2,
                                   atol=5e-2)


def test_sp_tp_prefill_collective_structure(ranks):
    """Per layer 2 Megatron all-reduces and 3 (n - 1) ring hops, per
    forward 1 lm_head all-gather and 1 owner all-reduce: JAX's lowered
    structure (the layer body once) times the layers, on every rank."""
    mesh = jmake_sp_mesh(4, 2)
    c = JModelConfig(**TINY)
    cache = jshard_sp(jkvc.init_cache(c.num_layers, 1, 16, c.num_kv_heads,
                                      c.head_dim), mesh)
    txt = jax.jit(jmake_sp(mesh), static_argnames=("cfg",)).lower(
        jshard(jparams("fp", 0, 2), mesh), c, jnp.zeros((1, 16), jnp.int32),
        cache).as_text()
    jc = {op: len(re.findall(r"stablehlo\." + op + r"\b", txt))
          for op in ("all_reduce", "all_gather", "collective_permute",
                     "all_to_all")}
    assert jc == {"all_reduce": 3, "all_gather": 1, "collective_permute": 9,
                  "all_to_all": 0}, jc
    n_layers = c.num_layers
    want = {"all_reduce": 2 * n_layers + 1, "all_gather": 1,
            "collective_permute": 9 * n_layers, "all_to_all": 0}
    for r in ranks():
        got = r["structure"]["stats"]
        assert {k: got[k] for k in want} == want
