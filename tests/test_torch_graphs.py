"""The port's captured device loops, held on the CPU: a CUDA graph cannot
run here, so these tests hold the code that the card captures. The decode
step's and the serving tick's bodies, run eagerly over their static
buffers, give the eager loops' tokens; a prefill with its real length on
the device gives the host-int prefill's bits; ``ctx_cap``'s buckets are
JAX's and leave a forward's bits alone; the launch counters count per
replay. Also the API gaps closed beside them: the hoisted ``logit_bias``,
``Engine(kv_dtype=)``, ``GenerationResult.tokens_per_s``,
``save_checkpoint`` and five ref ops, each against the JAX package."""

import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import engine as jengine
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.generation import sampling as jsmp
from tinychatengine_tpu.models import gptbigcode as jgpt
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.models import opt as jopt
from tinychatengine_tpu.ops import ref as jref
from tinychatengine_tpu.runtime.serving import _cap_bucket
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation import cuda_graph as cg
from tinychatengine_tpu_torch.generation import sampling as tsmp
from tinychatengine_tpu_torch.generation.engine import (DecodeStep, Engine,
                                                        GenerationResult,
                                                        PrefillStep,
                                                        ctx_cap_for)
from tinychatengine_tpu_torch.models import gptbigcode, llama, opt
from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops import ref as tref
from tinychatengine_tpu_torch.runtime.serving import ServingEngine, Tick
from tinychatengine_tpu_torch.tools import checkpoint as tckpt

LLAMA = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
             num_layers=2, max_sqlen=64, embed_dim=256, hidden_dim=512,
             vocab_size=300)
OPT = dict(name="tiny_opt", family="opt", num_heads=4, num_kv_heads=4,
           num_layers=2, max_sqlen=64, embed_dim=128, hidden_dim=256,
           vocab_size=300)
BIGCODE = dict(name="tiny_starcoder", family="gptbigcode", num_heads=4,
               num_kv_heads=1, num_layers=2, max_sqlen=64, embed_dim=128,
               hidden_dim=512, vocab_size=300)
SERVE = dict(LLAMA, max_sqlen=128, embed_dim=128, hidden_dim=256,
             vocab_size=256)
PROMPT = np.array([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(kind):
    """(port cfg, qcfg, params on the CPU) of a 2-layer model."""
    if kind.startswith("llama"):
        cfg, scheme = ModelConfig(**LLAMA), kind.split("-")[1]
        qcfg = QuantConfig(scheme=scheme)
        return cfg, qcfg, llama.init_random_params(cfg, qcfg, seed=2,
                                                   device="cpu")
    if kind == "opt-w8a8":
        cfg, qcfg = ModelConfig(**OPT), QuantConfig(scheme="w8a8")
        return cfg, qcfg, opt.init_random_params(cfg, quantized=True, seed=2,
                                                 device="cpu")
    cfg, qcfg = ModelConfig(**BIGCODE), QuantConfig(scheme="fp")
    return cfg, qcfg, gptbigcode.init_random_params(cfg, seed=2, qcfg=qcfg,
                                                    device="cpu")


GCFGS = {
    "greedy": GenerationConfig(temp=0.0, repeat_penalty=1.0,
                               repeat_last_n=1),
    "penalty": GenerationConfig(temp=0.0, repeat_penalty=1.3,
                                repeat_last_n=8),
    "sampled": GenerationConfig(temp=0.9, top_k=20, top_p=0.9,
                                repeat_penalty=1.1, repeat_last_n=8, seed=5,
                                logit_bias={7: 2.0}),
    "mirostat2": GenerationConfig(temp=1.0, mirostat=2, repeat_penalty=1.0,
                                  repeat_last_n=0, seed=3),
}


@pytest.mark.parametrize("gname", sorted(GCFGS))
@pytest.mark.parametrize("kind", ["llama-fp", "llama-w4a8", "opt-w8a8",
                                  "gptbigcode-fp"])
def test_step_body_matches_generate_device(kind, gname):
    """``DecodeStep.body`` (the step the card captures: sample, window,
    forward at device positions [B] int32 with ``ctx_cap``, all in place)
    run eagerly n times gives today's ``generate_device`` tokens, and the
    same cache contents and length (one run of the body advances the host
    length once; on the card the runner sets it, as a capture runs the body
    twice) and a mirostat mu moved in place."""
    cfg, qcfg, params = _model(kind)
    g = GCFGS[gname]
    n = 10
    eng = Engine(params, cfg, qcfg, device="cpu")
    want, wcache = eng.generate_device(PROMPT, g, n_tokens=n,
                                       return_cache=True)
    cache = eng.new_cache()
    logits, cache = eng.prefill(PROMPT, cache)
    cap = ctx_cap_for(PROMPT.shape[1] + n, eng.max_len)
    st = DecodeStep(eng, cache, tuple(logits.shape), g, cap)
    st.reset(logits, eng._prompt_window(PROMPT, g), PROMPT.shape[1], g.seed)
    for _ in range(n):
        st.body()
    assert st.out[:, :n].tolist() == want.tolist()
    m = PROMPT.shape[1] + n
    assert st.pos.tolist() == [m] and cache.length == wcache.length == m
    assert all(torch.equal(a[:, :, :, :m], b[:, :, :, :m]) for a, b in (
        (cache.k, wcache.k), (cache.v, wcache.v)))
    if g.mirostat:  # mu moved in place, as the eager state's did
        assert not torch.equal(st.sampler.mu,
                               torch.full((1,), 2.0 * g.mirostat_tau))


@pytest.mark.parametrize("kind", ["bf16", "int8", "raw_int8"])
def test_cache_copies_keep_positions(kind):
    """The graph path's cache copies (``generation/kv_cache.py``):
    ``fresh_like`` makes what ``init_cache`` makes (the JAX package's
    values: zero codes, unit scales), ``copy_positions`` moves exactly
    [lo, hi) of codes and scales, ``clone`` is a copy that shares
    nothing."""
    from tinychatengine_tpu_torch.generation import kv_cache as tkvc
    shape = (2, 1, 64, 2, 32)
    q = kind == "int8"
    dtype = torch.int8 if kind == "raw_int8" else torch.bfloat16
    src = tkvc.init_cache(*shape, dtype=dtype, quantized=q, device="cpu")
    ref = jkvc.init_cache(*shape, quantized=q)
    fresh = tkvc.fresh_like(src)
    assert tkvc.layout(fresh) == tkvc.layout(src) and fresh.length == 0
    for t, j in ((fresh.k, ref.k), (fresh.k_scale, ref.k_scale)):
        if t is not None:
            assert np.array_equal(t.float().numpy(),
                                  np.asarray(j, np.float32))
    gen = torch.Generator().manual_seed(1)
    for t in _bufs(src):
        t.copy_(torch.randint(-100, 100, t.shape, generator=gen))
    src.length = 40
    before = tkvc.clone(fresh)
    tkvc.copy_positions(src, fresh, 10, 30)
    for a, b, c in zip(_bufs(fresh), _bufs(src), _bufs(before)):
        assert torch.equal(a[:, :, :, 10:30], b[:, :, :, 10:30])
        assert torch.equal(a[:, :, :, :10], c[:, :, :, :10])
        assert torch.equal(a[:, :, :, 30:], c[:, :, :, 30:])
    twin = tkvc.clone(src)
    assert twin.length == 40
    assert all(torch.equal(a, b) for a, b in zip(_bufs(twin), _bufs(src)))
    twin.k.zero_()
    assert src.k.any()


def _bufs(cache) -> list:
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
            if t is not None]


def _busy_server(paged):
    """A 3-slot server with three requests (greedy with a penalty, top_p,
    top_k) admitted and decoding, the burst's pages granted."""
    cfg = ModelConfig(**SERVE)
    qcfg = QuantConfig(scheme="fp")
    params = llama.init_random_params(cfg, qcfg, seed=0, device="cpu")
    g = GenerationConfig(temp=0.0, n_predict=30, repeat_penalty=1.1,
                         repeat_last_n=8, seed=4)
    srv = ServingEngine(params, cfg, qcfg, slots=3, gcfg=g, tick_batch=8,
                        paged=paged, page_size=16, device="cpu")
    srv.submit(np.array([5, 9, 11]))
    srv.submit(np.array([7, 3, 8, 8]), gcfg=GenerationConfig(
        temp=1.1, top_p=0.9, n_predict=30, repeat_penalty=1.0,
        repeat_last_n=4, seed=33))
    srv.submit(np.arange(20, 40), gcfg=GenerationConfig(
        temp=0.7, top_k=5, n_predict=30, repeat_penalty=1.2,
        repeat_last_n=6, seed=8))
    while srv.queue or srv._pending is not None:
        srv.step()
    return srv


@pytest.mark.parametrize("paged", [False, True])
def test_serving_logprobs_tick_body_matches_eager_burst(paged):
    """The tick's logprobs variant (``Tick(lp_k=...)``, what the card
    captures when a row asks for logprobs) run K times over its static
    buffers gives the eager burst's tokens, logprobs and top ids."""
    srv = _busy_server(paged)
    srv.slots[0].request.logprobs = 3
    k = srv._burst_ticks()
    keys0, mu0 = srv._keys.clone(), srv._mu.clone()
    want, (lps, tops) = srv._eager_burst(k)
    srv._keys.copy_(keys0)
    srv._mu.copy_(mu0)
    tick = Tick(srv, srv._row_features(), srv._ctx_cap(k), srv.logprobs_k)
    tick.load(srv)
    for _ in range(k):
        tick.body()
    assert tick.seq[:k].numpy().tolist() == want.tolist()
    assert np.array_equal(tick.lp[:k].numpy(), lps)
    assert tick.top_i[:k].numpy().tolist() == \
        [[[i for i, _ in row] for row in t] for t in tops]


@pytest.mark.parametrize("paged", [False, True])
def test_serving_tick_body_matches_decode_burst(paged):
    """``Tick.body`` (the tick the card captures) run K times eagerly over
    its static buffers gives the eager burst's [K, B] tokens and leaves the
    rows' keys and mu where the eager burst left them."""
    srv = _busy_server(paged)
    k = srv._burst_ticks()
    assert k == 8 and srv.n_active == 3
    keys0, mu0 = srv._keys.clone(), srv._mu.clone()
    want, _ = srv._eager_burst(k)  # the tokens (no row asked for logprobs)
    keys1, mu1 = srv._keys.clone(), srv._mu.clone()
    srv._keys.copy_(keys0)
    srv._mu.copy_(mu0)
    tick = Tick(srv, srv._row_features(), srv._ctx_cap(k))
    tick.load(srv)
    for _ in range(k):
        tick.body()
    assert tick.seq[:k].numpy().tolist() == want.tolist()
    assert torch.equal(srv._keys, keys1) and torch.equal(srv._mu, mu1)
    assert (tick.ctx_cap is None) == paged


def _jax_pair(kind):
    """(JAX cfg, port cfg, qcfg, JAX params, the same params in the
    port)."""
    d = {"llama": LLAMA, "opt": OPT, "gptbigcode": BIGCODE}[
        kind.split("-")[0]]
    scheme = kind.split("-")[1]
    jcfg, cfg, qcfg = JModelConfig(**d), ModelConfig(**d), \
        QuantConfig(scheme=scheme)
    if cfg.family == "llama":
        jp = jllama.init_random_params(jcfg, JQuantConfig(scheme=scheme),
                                       seed=1)
    elif cfg.family == "opt":
        jp = jopt.init_random_params(jcfg, quantized=True, seed=1)
    else:
        jp = jgpt.init_random_params(jcfg, qcfg=JQuantConfig(scheme=scheme))
    mod = {"llama": llama, "opt": opt, "gptbigcode": gptbigcode}[cfg.family]
    tp = mod.params_from_numpy(jckpt._flatten(jp)[0], cfg, qcfg,
                               device="cpu")
    return jcfg, cfg, qcfg, jp, tp


@pytest.mark.parametrize("kind,tol", [("llama-w4a8", 4e-2),
                                      ("opt-w8a8", 1e-3),
                                      ("gptbigcode-fp", 2e-2)])
def test_device_true_len_prefill_matches_host_int(kind, tol):
    """A prefill whose real length is a 0-d int32 tensor (the captured
    prompt graph's static buffer) gives the host-int prefill's logits and
    cache bit for bit, without advancing the host length; and it lies
    within the family's forward tolerance (its tests/test_torch_*.py) of
    JAX's jitted prefill on the same weights."""
    jcfg, cfg, qcfg, jp, tp = _jax_pair(kind)
    jmod = {"llama": jllama, "opt": jopt, "gptbigcode": jgpt}[cfg.family]
    forward = {"llama": llama, "opt": opt, "gptbigcode": gptbigcode}[
        cfg.family].forward
    ids = np.zeros((1, 16), np.int64)
    ids[0, :12] = np.random.default_rng(0).integers(0, 300, 12)
    eng = Engine(tp, cfg, qcfg, device="cpu")
    c1, c2 = eng.new_cache(), eng.new_cache()
    l1, c1 = forward(tp, cfg, torch.from_numpy(ids), c1, 0, true_len=12)
    l2, c2 = forward(tp, cfg, torch.from_numpy(ids), c2, 0,
                     true_len=torch.tensor(12, dtype=torch.int32))
    assert torch.equal(l1, l2) and torch.equal(c1.k, c2.k) \
        and torch.equal(c1.v, c2.v)
    assert c1.length == 12 and c2.length == 0

    jc = jkvc.init_cache(cfg.num_layers, 1, cfg.max_sqlen, cfg.num_kv_heads,
                         cfg.head_dim,
                         dtype=jnp.int8 if qcfg.scheme == "w8a8"
                         else jnp.bfloat16)
    jl, _ = jax.jit(lambda p, i, c: jmod.forward(
        p, jcfg, i, c, jnp.int32(0), true_len=jnp.int32(12)))(
        jp, jnp.asarray(ids, jnp.int32), jc)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl)[:, :l2.shape[1]],
                               atol=tol, rtol=tol)


def test_embeds_prefill_step_body_matches_eager():
    """``PrefillStep`` with ``embed_dim`` (the captured graph of a prompt
    given as embeds) over its static buffers: the eager prefill's logits
    and cache bit for bit, not the ids' logits, and the cache's host
    length left to the caller."""
    cfg, qcfg = ModelConfig(**SERVE), QuantConfig(scheme="fp")
    params = llama.init_random_params(cfg, qcfg, seed=0, device="cpu")
    eng = Engine(params, cfg, qcfg, device="cpu")
    ids = PROMPT
    emb = params.embed[torch.from_numpy(ids)].float()
    emb[:, 2:6] = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 4, cfg.embed_dim)).astype(np.float32) * 0.05)
    want, c1 = eng.prefill(ids, eng.new_cache(), input_embeds=emb)
    c2 = eng.new_cache()
    st = PrefillStep(eng, c2, 1, 16, 0, cfg.embed_dim)
    st.ids[:, :ids.shape[1]] = torch.from_numpy(ids)
    st.embeds[:, :ids.shape[1]] = emb.to(torch.bfloat16)
    st.true_len.fill_(ids.shape[1])
    st.body()
    assert torch.equal(st.logits, want) and torch.equal(c1.k, c2.k)
    assert c2.length == 0 and c1.length == ids.shape[1]
    plain, _ = eng.prefill(ids, eng.new_cache())
    assert not torch.equal(plain, want)


def test_ctx_cap_matches_jax():
    """The Engine's bucket is JAX's ``generate_device`` formula and the
    server's is JAX's ``_cap_bucket`` (dense; paged ticks take none); a
    CPU forward with ``ctx_cap`` is bit-identical to one without."""
    for smax in (128, 2048, 4608):
        for needed in (1, 64, 511, 512, 513, 1000, 2049, 4608):
            assert ctx_cap_for(needed, smax) == _cap_bucket(needed, smax)
    # JAX's Engine computes the same bucket inline: the trace shows it
    seen = []

    def spy(params, cfg, logits, cache, *a):  # records the static bound
        seen.append(a[-1])
        return jnp.zeros((1, a[-3]), jnp.int32), cache
    jcfg = JModelConfig(**LLAMA)
    jp = jllama.init_random_params(jcfg, JQuantConfig(scheme="fp"), seed=0)
    jeng = jengine.Engine(jp, jcfg, JQuantConfig(scheme="fp"))
    old, jengine._device_decode_loop = jengine._device_decode_loop, spy
    try:
        jeng.generate_device(PROMPT, JGen(temp=0.0), n_tokens=4)
    finally:
        jengine._device_decode_loop = old
    assert seen == [ctx_cap_for(PROMPT.shape[1] + 4, jcfg.max_sqlen)]

    srv = _busy_server(False)
    assert srv._ctx_cap(8) == _cap_bucket(
        max(s.length for s in srv.slots) + 8, srv.max_len)
    assert _busy_server(True)._ctx_cap(8) is None

    cfg, qcfg, params = _model("llama-w4a8")
    eng = Engine(params, cfg, qcfg, device="cpu")
    outs = []
    for cap in (None, 512):
        cache = eng.new_cache()
        eng.prefill(PROMPT, cache)
        pos = torch.tensor([PROMPT.shape[1]], dtype=torch.int32)
        outs.append(llama.forward(params, cfg, torch.tensor([[7]]), cache,
                                  pos, ctx_cap=cap)[0])
    assert torch.equal(outs[0], outs[1])


class _Replayed:
    """A stand-in graph: counts its replays."""

    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def test_launch_deltas_added_per_replay():
    """``record_launches`` takes back what a captured body counted (the
    capture ran nothing) and its delta is added at every replay, to
    LAUNCHES and to every counter registered with ``counting`` (the
    plain-call counters), also when the body raises."""
    plain = {"flash_decode_plain": 0}
    saved = dict(_build.LAUNCHES)
    try:
        _build.reset_launches()
        with _build.counting(plain):
            with _build.record_launches() as delta:
                _build.LAUNCHES["flash_decode"] += 32
                _build.LAUNCHES["int4_matmul_a8"] += 129
                plain["flash_decode_plain"] += 1
            assert not any(_build.LAUNCHES.values())
            assert plain == {"flash_decode_plain": 0}
            step = cg.Step(lambda: None, None)
            step.graph, step.launches = _Replayed(), delta
            graphs = cg.Graphs("cpu")
            for _ in range(3):
                graphs.run(step)
            assert step.graph.n == 3
        assert _build.LAUNCHES["flash_decode"] == 96
        assert _build.LAUNCHES["int4_matmul_a8"] == 387
        assert plain["flash_decode_plain"] == 3
        assert plain not in _build.COUNTERS
        with pytest.raises(ValueError):
            with _build.record_launches():
                _build.LAUNCHES["flash_decode"] += 5
                raise ValueError("capture failed")
        assert _build.LAUNCHES["flash_decode"] == 96
    finally:
        _build.LAUNCHES.update(saved)


def test_logit_bias_hoisted_matches_jax():
    """``logit_bias_tensors`` built once outside the step and passed to
    ``sample`` gives what ``sample`` builds itself and what JAX's sample
    gives: a bias that moves the greedy token, with and without a
    penalty window."""
    x = np.random.default_rng(6).standard_normal((3, 200)).astype(np.float32)
    bias = {17: 9.0, 3: -4.0, 150: 5.5}
    last = np.random.default_rng(7).integers(-1, 200, (3, 8))
    for rp in (1.0, 1.3):
        g = GenerationConfig(temp=0.0, repeat_penalty=rp, logit_bias=bias)
        jg = JGen(temp=0.0, repeat_penalty=rp, logit_bias=bias)
        hoisted = tsmp.logit_bias_tensors(g, "cpu")
        state = tsmp.SamplerState.init(0, 3, 5.0, "cpu")
        got, _ = tsmp.sample(torch.from_numpy(x), state, g,
                             torch.from_numpy(last), bias=hoisted)
        inner, _ = tsmp.sample(torch.from_numpy(x), state, g,
                               torch.from_numpy(last))
        want, _ = jsmp.sample(jnp.asarray(x), jsmp.SamplerState.init(0, 3,
                                                                    5.0),
                              jg, jnp.asarray(last, jnp.int32))
        assert got.tolist() == inner.tolist() == np.asarray(want).tolist()
    assert tsmp.logit_bias_tensors(GenerationConfig(), "cpu") is None
    ids, vals = tsmp.logit_bias_tensors(
        GenerationConfig(logit_bias=[(5, 1.5), (2, -1.0)]), "cpu")
    assert ids.tolist() == [5, 2] and vals.tolist() == [1.5, -1.0]


def test_engine_kv_dtype_and_tokens_per_s_match_jax():
    """``Engine(kv_dtype=)`` stores the cache raw in that dtype as JAX's
    does, the default picks OPT W8A8's raw int8 and otherwise the quant
    config's storage; ``tokens_per_s`` is JAX's property."""
    cases = [(LLAMA, "fp", "bf16", None), (LLAMA, "w4a8", "int8", None),
             (LLAMA, "fp", "bf16", "int8"), (OPT, "w8a8", "bf16", None),
             (OPT, "w8a8", "bf16", "bf16")]
    dt = {"int8": (torch.int8, jnp.int8), "bf16": (torch.bfloat16,
                                                   jnp.bfloat16)}
    for d, scheme, kv, kv_dtype in cases:
        cfg, jcfg = ModelConfig(**d), JModelConfig(**d)
        eng = Engine(None, cfg, QuantConfig(scheme=scheme, kv_cache_dtype=kv),
                     device="cpu",
                     kv_dtype=kv_dtype and dt[kv_dtype][0])
        jeng = jengine.Engine(None, jcfg, JQuantConfig(
            scheme=scheme, kv_cache_dtype=kv),
            kv_dtype=kv_dtype and dt[kv_dtype][1])
        got, want = eng.new_cache(), jeng.new_cache()
        assert str(got.k.dtype).split(".")[-1] == str(want.k.dtype)
        assert got.quantized == want.quantized
        assert tuple(got.k.shape) == tuple(want.k.shape)
    for toks, secs in (([[1, 2, 3]], 0.5), ([[]], 0.5), ([[4]], 0.0), ([], 1)):
        kw = dict(tokens=toks, n_prompt=1, ttft_s=0.1, decode_s=secs)
        assert GenerationResult(**kw).tokens_per_s \
            == jengine.GenerationResult(**kw).tokens_per_s


def _members(path: Path) -> dict:
    """Each file of a checkpoint directory: meta.json's text, and each
    npz's members in order with their bytes."""
    out = {}
    for f in sorted(path.iterdir()):
        if f.suffix == ".npz":
            with zipfile.ZipFile(f) as z:
                out[f.name] = [(i.filename, z.read(i)) for i in z.infolist()]
        else:
            out[f.name] = f.read_text()
    return out


@pytest.mark.parametrize("kind", ["llama-w4a16", "llama-fp", "opt-w8a8",
                                  "gptbigcode-fp"])
def test_save_checkpoint_round_trips_through_the_jax_loader(kind, tmp_path):
    """Port save -> JAX load gives the port's leaves; JAX save -> port
    load -> port save writes the JAX package's files again (meta.json, and
    every npz member byte for byte)."""
    cfg, qcfg, params = _model(kind)
    jcfg = JModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "num_heads", "num_kv_heads", "num_layers",
        "max_sqlen", "embed_dim", "hidden_dim", "vocab_size")})
    jq = JQuantConfig(scheme=qcfg.scheme)
    tckpt.save_checkpoint(str(tmp_path / "port"), params, cfg, qcfg)
    jp, jq2 = jckpt.load_checkpoint(str(tmp_path / "port"), jcfg)
    assert jq2.scheme == qcfg.scheme
    flat = tckpt.flatten(params)
    jflat = jckpt._flatten(jp)[0]
    assert sorted(jflat) == sorted(flat)
    for k, t in flat.items():
        want = t.contiguous()
        want = (want.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                else want.numpy())
        got = jflat[k]
        got = got.view(np.int16) if got.dtype.kind == "V" else got
        np.testing.assert_array_equal(got, want, err_msg=k)

    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, jcfg, jq)
    tp, _ = tckpt.load_checkpoint(str(tmp_path / "jax"), cfg, device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "again"), tp, cfg, qcfg)
    assert _members(tmp_path / "again") == _members(tmp_path / "jax")


def _rng_arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("op", ["attention_ref", "softmax_ref",
                                "rotary_embed_ref", "quantize_act_int8",
                                "int4_matmul_ref"])
def test_ref_ops_match_jax(op):
    """The five ref ops the port lacked, on the same numpy inputs as the
    JAX package's (f32 and bf16 where the op keeps the input's dtype)."""
    if op == "attention_ref":
        q, k, v = _rng_arrays((2, 4, 5, 16), (2, 2, 7, 16), (2, 2, 7, 16))
        mask = np.where(np.tril(np.ones((5, 7)), 2) > 0, 0.0,
                        -1e9).astype(np.float32)[None, None]
        for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                             (torch.bfloat16, jnp.bfloat16, 1e-2)):
            got = tref.attention_ref(*(torch.from_numpy(a).to(dt)
                                       for a in (q, k, v)),
                                     torch.from_numpy(mask), 0.25)
            want = jref.attention_ref(*(jnp.asarray(a, jdt)
                                        for a in (q, k, v)),
                                      jnp.asarray(mask), 0.25)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)
    elif op == "softmax_ref":
        (x,) = _rng_arrays((3, 4, 50))
        for dim in (-1, 1):
            got = tref.softmax_ref(torch.from_numpy(x * 4), dim)
            want = jref.softmax_ref(jnp.asarray(x * 4), dim)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-5)
    elif op == "rotary_embed_ref":
        q, k = _rng_arrays((2, 6, 4, 64), (2, 6, 2, 64))
        pos = np.array([[0, 1, 2, 3, 4, 5], [9, 10, 11, 30, 31, 2]])
        cos, sin = tref.make_rope_cache(64, 40, 500000.0)
        jcos, jsin = jref.make_rope_cache(64, 40, 500000.0)
        got = tref.rotary_embed_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    cos, sin, torch.from_numpy(pos))
        want = jref.rotary_embed_ref(jnp.asarray(q), jnp.asarray(k), jcos,
                                     jsin, jnp.asarray(pos))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
    elif op == "quantize_act_int8":
        (x,) = _rng_arrays((4, 96))
        got_q, got_s = tref.quantize_act_int8(torch.from_numpy(x * 3))
        want_q, want_s = jax.jit(jref.quantize_act_int8)(jnp.asarray(x * 3))
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        assert float(got_s) == float(want_s)
    else:
        from tinychatengine_tpu_torch.ops.linear import quantized_linear
        (w, x) = _rng_arrays((300, 256), (3, 256), seed=1)
        lin = quantized_linear(w * 0.05, 128, "bf16")
        got = tref.int4_matmul_ref(torch.from_numpy(x), lin.packed,
                                   lin.scales, 128)
        want = jref.int4_matmul_ref(
            jnp.asarray(x), jnp.asarray(lin.packed.numpy()),
            jnp.asarray(lin.scales.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)), 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
