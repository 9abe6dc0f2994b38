"""The port's tensor/data-parallel layer against the JAX package's
(twins of ``tests/test_parallel.py``). One world of 8 ranks (gloo on the
CPU) runs every case's rank body once per module (``torch_ranks``); each
test holds the ranks' result to the JAX multi-device function on the
8-device virtual CPU mesh and to the JAX single-device oracle. Limits:
JAX's own 2e-2 on logits (fp and W4A16), greedy tokens exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.generation.engine import Engine as JEngine
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.models import opt as jopt
from tinychatengine_tpu.parallel.sharding import make_mesh as jmake_mesh
from tinychatengine_tpu.parallel.sharding import opt_param_specs as jopt_specs
from tinychatengine_tpu.parallel.sharding import shard_cache as jshard_cache
from tinychatengine_tpu.parallel.sharding import shard_params as jshard
from tinychatengine_tpu.parallel.tp import make_tp_forward as jmake_tp
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.quant.packing import numpy_to_torch

TINY = dict(name="tiny", family="llama", num_heads=8, num_kv_heads=4,
            num_layers=2, max_sqlen=64, embed_dim=1024, hidden_dim=1024,
            vocab_size=512, rms_norm_eps=1e-5)
OPT = dict(name="opt_tiny", family="opt", num_heads=8, num_kv_heads=8,
           num_layers=2, max_sqlen=64, embed_dim=1024, hidden_dim=2048,
           vocab_size=512)
TOL = dict(rtol=2e-2, atol=2e-2)
IDS8 = [[3, 1, 4, 1, 5, 9, 2, 6]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers (and this module's ranks beside
    them): one intra-op thread keeps torch's CPU ops from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(jparams) -> dict:
    """JAX parameters as the checkpoint's flat dict of torch tensors."""
    return {k: numpy_to_torch(v) for k, v in jckpt._flatten(jparams)[0].items()}


def jparams(scheme, seed, tp_degree=1, cfg=TINY):
    return _jparams(scheme, seed, tp_degree,
                    tuple(sorted(cfg.items())))


@functools.cache
def _jparams(scheme, seed, tp_degree, cfg_items):
    return jllama.init_random_params(JModelConfig(**dict(cfg_items)),
                                     JQuantConfig(scheme=scheme), seed=seed,
                                     tp_degree=tp_degree)


def jcache(cfg=TINY, batch=1):
    c = JModelConfig(**cfg)
    return jkvc.init_cache(c.num_layers, batch, c.max_sqlen, c.num_kv_heads,
                           c.head_dim)


@functools.cache
def _jit(fwd):
    return jax.jit(fwd, static_argnames=("cfg",))


def jforward1(params, ids, cfg=TINY, fwd=jllama.forward):
    out, _ = _jit(fwd)(params, JModelConfig(**cfg),
                       jnp.asarray(ids, jnp.int32), jcache(cfg), jnp.int32(0))
    return np.asarray(out)


def jforward_tp(params, ids, n_model, n_data=1, cfg=TINY, fwd=jllama.forward,
                specs=None):
    mesh = jmake_mesh(n_data=n_data, n_model=n_model)
    kw = {} if specs is None else dict(forward=fwd, param_specs_fn=specs)
    sp = jshard(params, mesh, **({} if specs is None else
                                 dict(specs_fn=specs)))
    out, cache = jax.jit(jmake_tp(mesh, **kw), static_argnames=("cfg",))(
        sp, JModelConfig(**cfg), jnp.asarray(ids, jnp.int32),
        jshard_cache(jcache(cfg), mesh), jnp.int32(0))
    return np.asarray(out), int(cache.length)


TP_CASES = [(s, n) for n in (2, 4) for s in ("fp", "w4a16")]


def _jobs():
    data, jobs = {}, [("foreign", "foreign_modules")]
    for scheme, n in TP_CASES:
        key = f"tp-{scheme}-{n}"
        data[key] = dict(cfg=TINY, qcfg=dict(scheme=scheme), n_model=n,
                         ids=IDS8, flat=flat(jparams(scheme, 0, n)))
        jobs.append((key, "tp_logits"))
    data["dp_tp"] = dict(cfg=TINY, flat=flat(jparams("fp", 1, 4)),
                         ids=[[1, 2, 3], [4, 5, 6]])
    data["consistency"] = dict(cfg=TINY, flat=flat(jparams("fp", 2, 4)),
                               ids=[[7, 8, 9, 10, 11]])
    data["opt"] = dict(cfg=OPT, flat=flat(jopt.init_random_params(
        JModelConfig(**OPT), quantized=False, seed=0)), ids=[[3, 1, 4, 1, 5]])
    for scheme in ("fp", "w4a16"):
        data[f"coll-{scheme}"] = dict(cfg=TINY, qcfg=dict(scheme=scheme),
                                      flat=flat(jparams(scheme, 0, 4)),
                                      ids=IDS8)
        jobs.append((f"coll-{scheme}", "tp_collectives"))
    data["scaling"] = dict(cfg=TINY)
    jobs += [("dp_tp", "dp_tp_decode"), ("consistency", "tp_prefill_decode"),
             ("opt", "opt_tp_logits"), ("multihost", "multihost_helpers"),
             ("scaling", "scaling_run")]
    return data, jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data, jobs = _jobs()
    launch = torch_ranks.world(tmp_path_factory.mktemp("tp"), data, jobs, 8)
    cached = []

    def results():
        if not cached:
            cached.append(launch.result())
        return cached[0]
    yield results
    results()  # a launch is always joined


def test_ranks_import_no_jax(ranks):
    assert all(r["foreign"] == [] for r in ranks())


@pytest.mark.parametrize("scheme", ["fp", "w4a16"])
@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_matches_single_device(ranks, scheme, n_model):
    want_1 = jforward1(jparams(scheme, 0), IDS8)
    want_n, _ = jforward_tp(jparams(scheme, 0, n_model), IDS8, n_model)
    res = ranks()
    got = res[0][f"tp-{scheme}-{n_model}"]
    np.testing.assert_allclose(got["logits"], want_n, **TOL)
    np.testing.assert_allclose(got["logits"], want_1, **TOL)
    assert got["length"] == 8
    for r in res[1:n_model]:  # every rank returns the global logits
        np.testing.assert_array_equal(r[f"tp-{scheme}-{n_model}"]["logits"],
                                      got["logits"])


def test_dp_tp_mesh_decode_loop(ranks):
    """2 data x 4 model: generate_device through the TP forward, token
    exact against JAX's TP engine and the single-device engine."""
    cfg, q = JModelConfig(**TINY), JQuantConfig(scheme="fp")
    g = JGen(temp=0.0, n_predict=4, repeat_penalty=1.0)
    ids = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    mesh = jmake_mesh(n_data=2, n_model=4)
    want_n = np.asarray(JEngine(jshard(jparams("fp", 1, 4), mesh), cfg, q,
                                batch=2, forward_fn=jmake_tp(mesh))
                        .generate_device(ids, g, n_tokens=4))
    want_1 = np.asarray(JEngine(jparams("fp", 1), cfg, q, batch=2)
                        .generate_device(ids, g, n_tokens=4))
    res = ranks()
    for r in res:
        assert r["dp_tp"]["graphs"]  # the TP forward runs eagerly
        np.testing.assert_array_equal(r["dp_tp"]["tokens"], want_n)
        np.testing.assert_array_equal(r["dp_tp"]["tokens"], want_1)


def test_tp_prefill_decode_cache_consistency(ranks):
    ids = [[7, 8, 9, 10, 11]]
    want, _ = jforward_tp(jparams("fp", 2, 4), ids, 4)
    got = ranks()[0]["consistency"]
    np.testing.assert_allclose(got["la"], got["lb"], **TOL)
    np.testing.assert_allclose(got["la"], want, **TOL)


def test_opt_tp_matches_single_device(ranks):
    params = jopt.init_random_params(JModelConfig(**OPT), quantized=False,
                                     seed=0)
    ids = [[3, 1, 4, 1, 5]]
    want_1 = jforward1(params, ids, OPT, jopt.forward)
    want_n, _ = jforward_tp(params, ids, 4, cfg=OPT, fwd=jopt.forward,
                            specs=jopt_specs)
    got = ranks()[0]["opt"]["logits"]
    np.testing.assert_allclose(got, want_n, **TOL)
    np.testing.assert_allclose(got, want_1, **TOL)


def _jax_counts(ids, scheme="fp"):
    import re
    mesh = jmake_mesh(n_data=1, n_model=4)
    txt = jax.jit(jmake_tp(mesh), static_argnames=("cfg",)).lower(
        jshard(jparams(scheme, 0, 4), mesh), JModelConfig(**TINY),
        jnp.asarray(ids, jnp.int32), jshard_cache(jcache(), mesh),
        jnp.int32(0)).as_text()
    return {op: len(re.findall(r"stablehlo\." + op + r"\b", txt))
            for op in ("all_reduce", "all_gather", "collective_permute",
                       "all_to_all")}


def _per_forward(jax_counts, n_layers):
    """JAX's lowered text holds the layer scan body once: a forward runs
    its collectives once per layer."""
    want = dict(jax_counts)
    want["all_reduce"] *= n_layers
    return want


def _port_counts(stats):
    return {k: stats[k] for k in ("all_reduce", "all_gather",
                                  "collective_permute", "all_to_all")}


@pytest.mark.parametrize("scheme", ["fp", "w4a16"])
def test_tp_decode_collective_structure(ranks, scheme):
    """The Megatron pattern per decode step: 2 all-reduces per layer and 1
    lm_head all-gather, no permute, no all-to-all, on every rank."""
    jc = _jax_counts([[3]], scheme)
    assert jc == {"all_reduce": 2, "all_gather": 1, "collective_permute": 0,
                  "all_to_all": 0}, jc
    want = _per_forward(jc, TINY["num_layers"])
    for r in ranks()[:4]:
        assert _port_counts(r[f"coll-{scheme}"]["decode"]) == want
        assert r[f"coll-{scheme}"]["decode"]["broadcast"] == 0


def test_tp_prefill_collective_structure(ranks):
    jc = _jax_counts(IDS8)
    want = _per_forward(jc, TINY["num_layers"])
    assert want == {"all_reduce": 4, "all_gather": 1, "collective_permute": 0,
                    "all_to_all": 0}
    for r in ranks()[:4]:
        assert _port_counts(r["coll-fp"]["prefill"]) == want


def test_multihost_mesh_helpers(ranks):
    for i, r in enumerate(ranks()):
        info = r["multihost"]["info"]
        assert info["process_count"] == 8 and info["process_index"] == i
        assert r["multihost"]["shape"] == {"data": 2, "model": 4}


def test_scaling_harness_runs(ranks):
    from tinychatengine_tpu.tools.scaling import run_config as jrun_config
    cfg = JModelConfig(**TINY)

    def params_fn(n_model):
        return jllama.init_random_params(cfg, JQuantConfig(scheme="fp"),
                                         seed=0, tp_degree=n_model)
    want = jrun_config(params_fn, cfg, JQuantConfig(scheme="fp"), 2, 4,
                       prompt_len=4, n_decode=3, trials=1)
    got = ranks()[0]["scaling"]
    assert got.keys() == want.keys()
    assert got["mesh"] == want["mesh"] == "2x4" and got["tokens_per_s"] > 0


# ---- the slow tier: a world of its own -------------------------------------

@pytest.fixture(scope="module")
def slow_ranks(tmp_path_factory):
    data = {"fused": dict(cfg=TINY, qcfg=dict(scheme="w4a16"),
                          flat=flat(jparams("w4a16", 3, 2)),
                          ids=[[3, 1, 4, 1, 5, 9]]),
            "dryrun": dict(cfg=TINY, qcfg=dict(scheme="w4a16"),
                           flat=flat(jparams("w4a16", 0, 2)),
                           ids=[[1, 2, 3], [4, 5, 6]])}
    jobs = [("fused", "tp_fused_decode"), ("dryrun", "dryrun_serving_step")]
    return torch_ranks.world(tmp_path_factory.mktemp("tp_slow"), data, jobs,
                             4).result()


@pytest.mark.slow
def test_tp_fused_decode_matches_single_device(slow_ranks, monkeypatch):
    """One decode step under TP with FUSED_DECODE on, against JAX's TP
    step (fused forced on, interpret-mode kernels) and the unfused
    single-device step."""
    from tinychatengine_tpu.ops import int4_matmul as jim
    cfg = JModelConfig(**TINY)
    ids = jnp.asarray([[3, 1, 4, 1, 5, 9]], jnp.int32)
    tok = jnp.asarray([[7]], jnp.int32)
    _, c1 = jllama.forward(jparams("w4a16", 3), cfg, ids, jcache(),
                           jnp.int32(0))
    want_1, _ = jllama.forward(jparams("w4a16", 3), cfg, tok, c1,
                               jnp.int32(6))
    mesh = jmake_mesh(n_data=1, n_model=2)
    sp = jshard(jparams("w4a16", 3, 2), mesh)
    fwd = jmake_tp(mesh)
    _, cn = fwd(sp, cfg, ids, jshard_cache(jcache(), mesh), jnp.int32(0))
    monkeypatch.setattr(jim, "FUSED_DECODE", True)
    monkeypatch.setattr(jim, "FUSED_FORCE", True)
    want_n, _ = fwd(sp, cfg, tok, cn, jnp.int32(6))
    got = slow_ranks[0]["fused"]["logits"]
    np.testing.assert_allclose(got, np.asarray(want_n), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_1), **TOL)


@pytest.mark.slow
def test_multiprocess_distributed_dryrun(slow_ranks):
    """The launcher's own world (4 spawned ranks, a file store): a 2 x 2
    TP x DP decode equals the single-device engine, token for token."""
    cfg, q = JModelConfig(**TINY), JQuantConfig(scheme="w4a16")
    g = JGen(temp=0.0, n_predict=4, repeat_penalty=1.0, repeat_last_n=1)
    want = np.asarray(JEngine(jparams("w4a16", 0), cfg, q, batch=2)
                      .generate_device(np.asarray([[1, 2, 3], [4, 5, 6]],
                                                  np.int32), g, n_tokens=4))
    for i, r in enumerate(slow_ranks):
        assert r["dryrun"]["info"]["process_count"] == 4
        np.testing.assert_array_equal(r["dryrun"]["tokens"], want)
