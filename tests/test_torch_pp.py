"""The port's pipeline-parallel forward against the JAX package's (twins
of ``tests/test_pp.py``): prefill logits and every stage's KV, greedy
decode chains, the int8 KV cache, in-stage TP and the other families,
held to JAX's PP forward on the 8-device virtual CPU mesh and to the
single-device oracle within JAX's 2e-2, tokens exact. One world of 4 ranks
runs every case once per module (``torch_ranks``)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from test_torch_parallel import TOL, flat
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.models import gptbigcode as jbc
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.models import opt as jopt
from tinychatengine_tpu.parallel.pp import make_pp_forward as jmake_pp
from tinychatengine_tpu.parallel.pp import make_pp_mesh as jmake_pp_mesh
from tinychatengine_tpu.parallel.pp import shard_pp as jshard_pp

TINY = dict(name="tiny", family="llama", num_heads=8, num_kv_heads=4,
            num_layers=4, max_sqlen=64, embed_dim=1024, hidden_dim=1024,
            vocab_size=512, rms_norm_eps=1e-5)
BC = dict(name="tiny_bc", family="gptbigcode", num_heads=4, num_kv_heads=1,
          num_layers=4, max_sqlen=64, embed_dim=128, hidden_dim=256,
          vocab_size=300)
OPTC = dict(name="tiny_opt", family="opt", num_heads=4, num_kv_heads=4,
            num_layers=4, max_sqlen=64, embed_dim=128, hidden_dim=256,
            vocab_size=300)
PREFILL = [("fp", 4, 4), ("fp", 2, 2), ("w4a16", 4, 2)]
FAMILIES = {"gptbigcode": (BC, jbc), "opt": (OPTC, jopt)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers (and this module's ranks beside
    them): one intra-op thread keeps torch's CPU ops from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def jparams(scheme, seed, tp_degree=1):
    return jllama.init_random_params(JModelConfig(**TINY),
                                     JQuantConfig(scheme=scheme), seed=seed,
                                     tp_degree=tp_degree)


@functools.cache
def jfamily(family):
    cfg, mod = FAMILIES[family]
    return mod.init_random_params(JModelConfig(**cfg), seed=0)


def jcache(cfg, b, quantized=False):
    c = JModelConfig(**cfg)
    return jkvc.init_cache(c.num_layers, b, c.max_sqlen, c.num_kv_heads,
                           c.head_dim, quantized=quantized)


def ids(seed, vocab=512, lo=0):
    return np.random.default_rng(seed).integers(lo, vocab, (4, 8)).astype(
        np.int32)


@functools.cache
def _jit(fn):
    return jax.jit(fn, static_argnames=("cfg",))


@functools.cache
def _jpp(n_pipe, n_model, n_micro, forward=jllama.forward):
    mesh = jmake_pp_mesh(n_pipe, n_model)
    return mesh, _jit(jmake_pp(mesh, n_micro, forward=forward))


def jchain(fwd, params, cfg, first, cache, steps, tokens=None):
    """Prefill then greedy (or the given) tokens: the logits of each."""
    c = JModelConfig(**cfg)
    lg, cache = fwd(params, c, jnp.asarray(first), cache, jnp.int32(0))
    out, pos = [np.asarray(lg)], first.shape[1]
    for i in range(steps):
        tok = (jnp.asarray(tokens[i]) if tokens is not None
               else jnp.argmax(lg, -1).astype(jnp.int32)[:, None])
        lg, cache = fwd(params, c, tok, cache, jnp.int32(pos))
        out.append(np.asarray(lg))
        pos += 1
    return out, cache


def jpp_chain(params, cfg, first, n_pipe, n_micro, steps=0, n_model=1,
              forward=jllama.forward, quantized=False, tokens=None):
    mesh, fwd = _jpp(n_pipe, n_model, n_micro, forward)
    sp, sc = jshard_pp(params, jcache(cfg, first.shape[0], quantized), mesh)
    return jchain(fwd, sp, cfg, first, sc, steps, tokens)


def _jobs():
    data, jobs = {}, []
    for scheme, n_pipe, n_micro in PREFILL:
        key = f"prefill-{scheme}-{n_pipe}-{n_micro}"
        data[key] = dict(cfg=TINY, qcfg=dict(scheme=scheme), n_pipe=n_pipe,
                         n_micro=n_micro, ids=ids(0),
                         flat=flat(jparams(scheme, 0)))
        jobs.append((key, "pp_run"))
    data["decode"] = dict(cfg=TINY, n_pipe=4, n_micro=2, ids=ids(1), steps=3,
                          flat=flat(jparams("fp", 1)))
    data["int8"] = dict(cfg=TINY, n_pipe=4, n_micro=4, ids=ids(2), int8=True,
                        flat=flat(jparams("fp", 2)))
    data["structure"] = dict(cfg=TINY, n_pipe=4, n_micro=4,
                             ids=np.zeros((4, 8), np.int32),
                             flat=flat(jparams("fp", 0)))
    jobs += [(k, "pp_run") for k in ("decode", "int8", "structure")]
    for scheme in ("fp", "w4a16"):
        tok = _pp_tp_oracle(scheme)[2]
        data[f"pp_tp-{scheme}"] = dict(
            cfg=TINY, qcfg=dict(scheme=scheme), n_pipe=2, n_model=2,
            n_micro=2, ids=ids(3), steps=1, tokens=[np.asarray(tok)],
            flat=flat(jparams(scheme, 0, 2)))
        jobs.append((f"pp_tp-{scheme}", "pp_run"))
    data["pp_tp-structure"] = dict(cfg=TINY, n_pipe=2, n_model=2, n_micro=2,
                                   ids=np.zeros((4, 8), np.int32),
                                   flat=flat(jparams("fp", 0, 2)))
    jobs.append(("pp_tp-structure", "pp_run"))
    for family, (cfg, _) in FAMILIES.items():
        data[f"family-{family}"] = dict(
            cfg=cfg, qcfg=dict(scheme="fp"), n_pipe=4, n_micro=2, steps=2,
            ids=ids(2, cfg["vocab_size"], 5), flat=flat(jfamily(family)))
        jobs.append((f"family-{family}", "pp_run"))
    return data, jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data, jobs = _jobs()
    launch = torch_ranks.world(tmp_path_factory.mktemp("pp"), data, jobs, 4)
    cached = []

    def results():
        if not cached:
            cached.append(launch.result())
        return cached[0]
    yield results
    results()


# the PP logits over the int8 KV cache against JAX's runs, which read a
# bf16-dequantized cache: 0.0249 at most at E 1024, 4 layers, B 4, S 8
# (max |logit| 2.31), 1 of 2048 past TOL; the W4A8 logits' atol
INT8_KV_TOL = dict(rtol=2e-2, atol=4e-2)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want).astype(np.float32),
                               **tol)


@pytest.mark.parametrize("scheme,n_pipe,n_micro", PREFILL)
def test_pp_prefill_matches_single_device(ranks, scheme, n_pipe, n_micro):
    """Logits and every stage's KV slice against the single device and
    JAX's PP forward, with microbatch counts that fill the pipeline (M = B)
    and that do not (M < B)."""
    first = ids(0)
    one, c1 = jchain(_jit(jllama.forward), jparams(scheme, 0), TINY, first,
                     jcache(TINY, 4), 0)
    many, cn = jpp_chain(jparams(scheme, 0), TINY, first, n_pipe, n_micro)
    got = ranks()[0][f"prefill-{scheme}-{n_pipe}-{n_micro}"]
    for want in (one[0], many[0]):
        _close(got["logits"][0], want)
    assert got["length"] == 8
    for name in ("k", "v"):
        for want in (getattr(c1, name), getattr(cn, name)):
            _close(got[name], want[:, :, :, :8])


def test_pp_decode_steps_match_single_device(ranks):
    """Prefill and 3 greedy steps through the pipeline: token-exact with
    the single device, logits within the limit of both."""
    first = ids(1)
    one, _ = jchain(_jit(jllama.forward), jparams("fp", 1), TINY, first,
                    jcache(TINY, 4), 3)
    many, _ = jpp_chain(jparams("fp", 1), TINY, first, 4, 2, 3)
    got = ranks()[0]["decode"]["logits"]
    assert len(got) == 4
    for g, w1, wn in zip(got, one, many):
        assert (np.argmax(g, -1) == np.argmax(w1, -1)).all()
        _close(g, w1)
        _close(g, wn)


def test_pp_int8_kv_cache(ranks):
    """The quantized KV cache: each microbatch's scales commit too. The
    port's int8-KV attention keeps the TPU kernel's cast points (exact
    codes times scales), JAX's CPU oracle reads a bf16-dequantized cache,
    so from layer 1 on a code may sit one step apart (ROADMAP.md Queue
    3): the logits are held to the port's own single-device run within
    the pipeline's limit, to JAX's single-device and pipelined runs
    within ``INT8_KV_TOL``, the first layer's codes and scales to JAX's
    exactly, and every layer's scales to JAX's within its limit."""
    from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
    from tinychatengine_tpu_torch.generation import kv_cache as tkvc
    from tinychatengine_tpu_torch.models import llama
    first = ids(2)
    one, c1 = jchain(_jit(jllama.forward), jparams("fp", 2), TINY, first,
                     jcache(TINY, 4, True), 0)
    many, cn = jpp_chain(jparams("fp", 2), TINY, first, 4, 4, quantized=True)
    np.testing.assert_array_equal(np.asarray(cn.k), np.asarray(c1.k))
    cfg = ModelConfig(**TINY)
    tp = llama.params_from_numpy(flat(jparams("fp", 2)), cfg,
                                 QuantConfig(scheme="fp"), device="cpu")
    solo, _ = llama.forward(tp, cfg, torch.as_tensor(first, dtype=torch.int64),
                            tkvc.init_cache(4, 4, 64, 4, 128, quantized=True,
                                            device="cpu"), 0)
    got = ranks()[0]["int8"]
    _close(got["logits"][0], solo.numpy())
    for want in (one, many):  # JAX's single device and JAX's pipeline
        _close(got["logits"][0], want[0], INT8_KV_TOL)
    np.testing.assert_array_equal(got["k"][0], np.asarray(c1.k[0, :, :, :8]))
    np.testing.assert_array_equal(got["k_scale"][0],
                                  np.asarray(c1.k_scale[0, :, :, :8]))
    for want in (c1, cn):
        np.testing.assert_allclose(got["k_scale"],
                                   np.asarray(want.k_scale[:, :, :, :8]),
                                   rtol=2e-2, atol=1e-6)


def _jax_counts(n_pipe, n_model, n_micro, tp_degree):
    mesh, fwd = _jpp(n_pipe, n_model, n_micro)
    sp, sc = jshard_pp(jparams("fp", 0, tp_degree), jcache(TINY, 4), mesh)
    txt = fwd.lower(sp, JModelConfig(**TINY), jnp.zeros((4, 8), jnp.int32),
                    sc, jnp.int32(0)).as_text()
    return {op: len(re.findall(r"stablehlo\." + op + r"\b", txt))
            for op in ("all_reduce", "all_gather", "collective_permute",
                       "all_to_all")}


def _port(stats):
    return {k: stats[k] for k in ("all_reduce", "all_gather",
                                  "collective_permute", "all_to_all")}


def test_pp_collective_structure(ranks):
    """JAX's tick body holds one activation hop; its program one logits
    sum. The port runs M + n - 1 ticks of one hop each and the one sum:
    no other traffic, on every stage."""
    jc = _jax_counts(4, 1, 4, 1)
    assert jc == {"all_reduce": 1, "all_gather": 0, "collective_permute": 1,
                  "all_to_all": 0}, jc
    want = {"all_reduce": 1, "all_gather": 0,
            "collective_permute": (4 + 4 - 1) * jc["collective_permute"],
            "all_to_all": 0}
    for r in ranks():
        assert _port(r["structure"]["stats"]) == want


@functools.cache
def _pp_tp_oracle(scheme):
    first = ids(3)
    one, _ = jchain(_jit(jllama.forward), jparams(scheme, 0), TINY, first,
                    jcache(TINY, 4), 1)
    tok = np.argmax(one[0], -1).astype(np.int32)[:, None]
    return one, first, tok


@pytest.mark.parametrize("scheme", ["fp", "w4a16"])
def test_pp_tp_matches_single_device(ranks, scheme):
    """2 pipe x 2 model: Megatron TP inside each stage with the pipeline
    hop; prefill and one decode step (the single device's token)."""
    one, first, tok = _pp_tp_oracle(scheme)
    many, _ = jpp_chain(jparams(scheme, 0, 2), TINY, first, 2, 2, 1,
                        n_model=2, tokens=[tok])
    got = ranks()[0][f"pp_tp-{scheme}"]["logits"]
    assert (np.argmax(got[0], -1) == tok[:, 0]).all()
    for i in range(2):
        _close(got[i], one[i])
        _close(got[i], many[i])


def test_pp_tp_collective_structure(ranks):
    """PP x TP: JAX's tick body holds 2 Megatron all-reduces (the layer
    body), 1 lm_head all-gather and 1 hop, its program 1 logits sum. The
    port runs each stage's 2 local layers on its M valid ticks (bubbles
    compute nothing), the head on the last stage's M exits, and
    M + n - 1 hops."""
    jc = _jax_counts(2, 2, 2, 2)
    assert jc == {"all_reduce": 3, "all_gather": 1, "collective_permute": 1,
                  "all_to_all": 0}, jc
    m, n, local_layers = 2, 2, TINY["num_layers"] // 2
    for rank, r in enumerate(ranks()):
        stage = rank // 2
        want = {"all_reduce": 2 * local_layers * m + 1,
                "all_gather": m if stage == n - 1 else 0,
                "collective_permute": m + n - 1, "all_to_all": 0}
        assert _port(r["pp_tp-structure"]["stats"]) == want


@pytest.mark.parametrize("family", ["gptbigcode", "opt"])
def test_pp_family_agnostic_matches_single_device(ranks, family):
    """GPTBigCode (MQA, learned positions) and OPT (f32 activations,
    position offset 2) through the same schedule: prefill and 2 greedy
    steps token-exact with the single device."""
    cfg, mod = FAMILIES[family]
    first = ids(2, cfg["vocab_size"], 5)
    one, _ = jchain(_jit(mod.forward), jfamily(family), cfg, first,
                    jcache(cfg, 4), 2)
    many, _ = jpp_chain(jfamily(family), cfg, first, 4, 2, 2,
                        forward=mod.forward)
    got = ranks()[0][f"family-{family}"]["logits"]
    for g, w1, wn in zip(got, one, many):
        np.testing.assert_array_equal(np.argmax(g, -1), np.argmax(w1, -1))
        _close(g, w1)
        _close(g, wn)


def test_pp_generic_specs_reject_tp():
    """The generic (non-llama) specs are pure-pipe: in-stage TP fails
    loudly on both sides."""
    from tinychatengine_tpu.parallel.pp import _pp_param_specs as jspecs
    from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
    from tinychatengine_tpu_torch.models import gptbigcode
    from tinychatengine_tpu_torch.parallel.pp import _pp_param_specs
    cfg = dict(BC, num_layers=2, max_sqlen=32)
    jp = jbc.init_random_params(JModelConfig(**cfg), seed=0)
    with pytest.raises(AssertionError, match="llama-only"):
        jspecs(jp, tp=True)
    tp = gptbigcode.params_from_numpy(flat(jp), ModelConfig(**cfg),
                                      QuantConfig(scheme="fp"), device="cpu")
    with pytest.raises(ValueError, match="llama-only"):
        _pp_param_specs(tp, tp=True)
    assert _pp_param_specs(tp)["layers"]["c_attn"]["weight"] == (
        "pipe", None, None)
