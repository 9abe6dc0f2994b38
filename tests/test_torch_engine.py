"""The port's Engine, sampling and perplexity on the CPU: the bytellama_5m
fp goldens token-exact, the device loop against the host loop, chunked
prefill, and sampling against the JAX package on the same logits."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.generation import sampling as jsmp
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig,
                                                  get_model_config)
from tinychatengine_tpu_torch.generation import sampling as tsmp
from tinychatengine_tpu_torch.generation.engine import Engine, _bucket
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
from tinychatengine_tpu_torch.tools.perplexity import perplexity

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "assets" / "bytellama_5m"
GOLDEN = REPO / "tests" / "golden"
TINY = ModelConfig(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
                   num_layers=2, max_sqlen=128, embed_dim=256,
                   hidden_dim=512, vocab_size=512, rms_norm_eps=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def trained():
    if not (CKPT / "meta.json").exists():
        pytest.skip("trained checkpoint not present")
    cfg = get_model_config("bytellama_5m")
    params, _ = load_checkpoint(str(CKPT), cfg, device="cpu")
    return cfg, params


@pytest.fixture(scope="module")
def tiny_engine():
    params = llama.init_random_params(TINY, QuantConfig(scheme="w4a8"),
                                      seed=0, device="cpu")
    return Engine(params, TINY, QuantConfig(scheme="w4a8"), device="cpu")


@pytest.mark.parametrize("golden", ["bytellama_greedy.json",
                                    "bytellama_goldens.json"])
def test_fp_goldens_token_exact(trained, golden):
    """The committed JAX greedy transcripts, with the settings of the JAX
    package's tests/test_accuracy.py."""
    cfg, params = trained
    golds = json.loads((GOLDEN / golden).read_text())
    golds = golds if isinstance(golds, list) else [golds]
    eng = Engine(params, cfg, QuantConfig(scheme="fp"), batch=1,
                 max_len=cfg.max_sqlen, device="cpu")
    tok = ByteTokenizer()
    for gold in golds:
        ids = np.asarray(tok.encode(gold["prompt"]))[None, :]
        g = GenerationConfig(temp=0.0, n_predict=gold["n_predict"],
                             repeat_penalty=1.0, repeat_last_n=1)
        got = eng.generate(ids, g).tokens[0]
        assert got == gold["token_ids"], tok.decode(got)


@pytest.mark.parametrize("penalty", [1.0, 1.1])
def test_device_loop_equals_host_loop(tiny_engine, penalty):
    g = GenerationConfig(temp=0.0, n_predict=12, repeat_penalty=penalty,
                         repeat_last_n=8)
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    host = tiny_engine.generate(prompt, g).tokens[0]
    dev = tiny_engine.generate_device(prompt, g)
    assert dev.shape == (1, 12) and dev.dtype == torch.int32
    assert dev[0].tolist() == host


def test_generate_device_with_a_filled_cache_matches_jax():
    """With a caller's cache that already holds a longer prompt, both
    packages prefill the new prompt at position 0 and decode from its
    length: the same tokens as each other and as a fresh cache."""
    from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
    from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
    from tinychatengine_tpu.generation.engine import Engine as JEngine
    from tinychatengine_tpu.models import llama as jllama
    from tinychatengine_tpu.tools import checkpoint as jckpt
    jcfg = JModelConfig(**{f: getattr(TINY, f) for f in (
        "name", "family", "num_heads", "num_kv_heads", "num_layers",
        "max_sqlen", "embed_dim", "hidden_dim", "vocab_size",
        "rms_norm_eps")})
    jp = jllama.init_random_params(jcfg, JQuantConfig(scheme="fp"), seed=5)
    params = llama.params_from_numpy(jckpt._flatten(jp)[0], TINY,
                                     QuantConfig(scheme="fp"), device="cpu")
    old = np.arange(3, 43)[None] % 500          # 40 tokens already cached
    prompt = np.array([[9, 8, 7, 6, 5, 4, 3]])
    jeng = JEngine(jp, jcfg, JQuantConfig(scheme="fp"), batch=1)
    eng = Engine(params, TINY, QuantConfig(scheme="fp"), device="cpu")
    jg, g = JGen(temp=0.0, n_predict=8), GenerationConfig(temp=0.0,
                                                          n_predict=8)
    _, jcache = jeng.prefill(old, jeng.new_cache())
    _, cache = eng.prefill(old, eng.new_cache())
    want = np.asarray(jeng.generate_device(prompt, jg, cache=jcache))
    got = eng.generate_device(prompt, g, cache=cache)
    assert got.tolist() == want.tolist()
    assert got.tolist() == eng.generate_device(prompt, g).tolist()


def test_generate_device_past_max_len_raises():
    """n_prompt + n_tokens > max_len: the port's decode step at position
    max_len raises ``ValueError("KV cache full")``. JAX's loop runs on
    instead: its ``dynamic_update_slice`` clamps the write onto the last
    cache position (tinychatengine_tpu/generation/kv_cache.py:99-111), so it
    overwrites that entry and returns tokens computed over the overwritten
    cache. Up to max_len the port decodes as before."""
    params = llama.init_random_params(TINY, QuantConfig(scheme="w4a16"),
                                      seed=1, device="cpu")
    eng = Engine(params, TINY, QuantConfig(scheme="w4a16"), max_len=32,
                 device="cpu")
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    g = GenerationConfig(temp=0.0, n_predict=24)
    assert eng.generate_device(prompt, g).shape == (1, 24)  # 8 + 24 = 32
    with pytest.raises(ValueError, match="KV cache full"):
        eng.generate_device(prompt, g, n_tokens=25)


def test_chunked_prefill_matches_single_shot(tiny_engine, monkeypatch):
    prompt = np.arange(1, 41)[None] % 500
    single, cache1 = tiny_engine.prefill(prompt, tiny_engine.new_cache())
    monkeypatch.setattr(Engine, "CHUNK", 16)
    chunked, cache2 = tiny_engine.prefill(prompt, tiny_engine.new_cache())
    assert cache1.length == cache2.length == 40
    # chunks see the same keys; only the bucket padding of the last chunk
    # differs, which causality keeps out of the real rows: bf16 noise only
    np.testing.assert_allclose(chunked.numpy(), single.numpy(), atol=3e-2,
                               rtol=3e-2)


def test_stop_token_streaming_and_bucket(tiny_engine):
    assert _bucket(1) == 16 and _bucket(17) == 32
    g = GenerationConfig(temp=0.0, n_predict=10)
    first = tiny_engine.generate([[1, 2, 3]], g).tokens[0]
    stopped = tiny_engine.generate([[1, 2, 3]], g,
                                   stop_token_ids=[first[2]]).tokens[0]
    assert stopped == first[:first.index(first[2]) + 1]
    seen = []
    streamed = tiny_engine.generate(
        [[1, 2, 3]], g, on_token=lambda t: seen.append(t) or len(seen) < 4)
    assert seen == first[:4] == streamed.tokens[0]


def test_chip_smoke_phases_rehearse_on_cpu(trained):
    """chip_smoke.py's main-path and real-weights phases, run on the CPU at
    bytellama_5m's size (the card runs llama3_8b): control flow, shapes,
    the 2-layer cut check, goldens and ppl budgets."""
    import chip_smoke

    launches, per_step, metrics = chip_smoke.main_path(
        model="bytellama_5m", dev="cpu", long_len=512)
    # the CPU takes the plain versions: no kernel launches
    assert not any(launches.values()) and not any(per_step.values())
    assert metrics["decode_tok_s"] > 0
    ppl = chip_smoke.real_weights(dev="cpu")
    assert ppl["fp"] < 3.5
    serving = chip_smoke.serving_path(model="bytellama_5m", dev="cpu",
                                      n_requests=6, n_predict=8, max_len=512)
    for mode in ("dense", "paged"):
        assert serving[mode]["tokens"] == 48
        assert not any(serving[mode]["launches"].values())
    assert serving["greedy_dense_eq_paged"] == [2, 2]
    matched = chip_smoke.real_weights_serving(dev="cpu")
    assert all(min(m) == 48 for k, m in matched.items() if k.startswith("fp"))


def test_chip_smoke_int8_kv_phases_rehearse_on_cpu(trained):
    """chip_smoke.py's int8-KV phases (4c-4e) on the CPU at bytellama_5m's
    size in W4A8 (the card runs llama3_8b): the Engine run with the int8
    cache and its first step against bf16 KV, the long-context serving
    runs (bf16 dense, int8 dense, int8 paged) and the prefix cache (>= 3
    hits of 4, the same tokens with and without it, dense and paged)."""
    import chip_smoke
    from tinychatengine_tpu_torch.tools.convert import requantize_llama
    cfg, fp = trained
    qcfg = QuantConfig(scheme="w4a8", group_size=128)
    model = (requantize_llama(fp, qcfg), qcfg)
    launches, per_step, metrics = chip_smoke.int8_kv_engine(
        "bytellama_5m", model, dev="cpu", long_len=512, n_predict=8)
    assert not any(launches.values()) and not any(per_step.values())
    first = metrics["first_step_vs_bf16_kv"]
    assert 0 < first["rel_diff"] < 0.1 and first["same_argmax"]
    long_ctx = chip_smoke.long_serving("bytellama_5m", model, dev="cpu",
                                       n_requests=3, n_predict=4,
                                       max_len=512, plen=(200, 400))
    assert sorted(long_ctx) == ["bf16 dense", "int8 dense", "int8 paged"]
    assert all(m["tokens"] == 12 for m in long_ctx.values())
    pfx = chip_smoke.prefix_serving("bytellama_5m", model, dev="cpu",
                                    n_requests=4, header=128, tails=(16, 64),
                                    n_predict=4, max_len=512,
                                    admission_chunk=64)
    assert pfx["dense uncached"]["prefix_stats"] is None
    for run in ("dense cached", "paged cached"):
        assert pfx[run]["prefix_stats"]["hits"] == 3
        assert pfx[run]["prefix_stats"]["hit_tokens"] >= 3 * 128
    assert all(pfx["tokens_equal_uncached"].values())


def test_quantize_linear_defaults_to_the_card():
    """``tools.convert.quantize_linear`` without ``device`` asks for the
    card, as the port's other entry points do (here, with no card: the
    ``resolve_device`` error); ``device="cpu"`` gives the JAX package's
    packed bytes."""
    from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
    from tinychatengine_tpu.tools.convert import quantize_linear as jql
    from tinychatengine_tpu_torch.tools.convert import quantize_linear
    w = np.random.default_rng(0).standard_normal((256, 512)).astype(
        np.float32) * 0.02
    qcfg = QuantConfig(scheme="w4a8", group_size=128)
    if torch.cuda.is_available():
        assert quantize_linear(w, qcfg).packed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quantize_linear(w, qcfg)
    got = quantize_linear(w, qcfg, device="cpu")
    want = jql(w, JQuantConfig(scheme="w4a8", group_size=128))
    assert got.packed.device.type == "cpu"
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))


def test_perplexity_matches_jax(trained):
    """Same windows and masking as the JAX harness on 1024 eval tokens."""
    from tinychatengine_tpu.core.config import get_model_config as jget
    from tinychatengine_tpu.models import llama as jllama
    from tinychatengine_tpu.tools.checkpoint import load_checkpoint as jload
    from tinychatengine_tpu.tools.perplexity import perplexity as jppl
    cfg, params = trained
    text = (CKPT / "eval_sample.txt").read_text(encoding="utf-8")
    ids = np.asarray(ByteTokenizer().encode(text))[:1024]
    got = perplexity(llama.forward, params, cfg, ids, 512, 256)
    jparams, _ = jload(str(CKPT), jget("bytellama_5m"))
    want = jppl(jllama.forward, jparams, jget("bytellama_5m"), ids, 512, 256)
    assert got < 3.5
    assert abs(got - want) / want < 2e-3  # bf16 noise on a mean of 1023 nll


# ---- sampling: same logits on both sides ----------------------------------

def _logits(seed, b=3, v=200):
    x = np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32)
    return x * 3, jnp.asarray(x * 3), torch.from_numpy(x * 3)


def _kept(masked) -> np.ndarray:
    return np.asarray(masked) > -1e29


@pytest.mark.parametrize("name,arg", [("top_k_mask", 20), ("top_p_mask", 0.8),
                                      ("tail_free_mask", 0.9),
                                      ("typical_mask", 0.7)])
def test_truncation_masks_keep_the_jax_sets(name, arg):
    _, jl, tl = _logits(0)
    want = _kept(getattr(jsmp, name)(jl, arg))
    got = _kept(getattr(tsmp, name)(tl, arg).numpy())
    np.testing.assert_array_equal(got, want)


def test_penalties_match_jax():
    _, jl, tl = _logits(1)
    last = np.random.default_rng(2).integers(-1, 200, (3, 16))
    jlast, tlast = jnp.asarray(last, jnp.int32), torch.from_numpy(last)
    np.testing.assert_allclose(
        tsmp.apply_repetition_penalty(tl, tlast, 1.3).numpy(),
        np.asarray(jsmp.apply_repetition_penalty(jl, jlast, 1.3)), rtol=1e-6)
    np.testing.assert_allclose(
        tsmp.apply_frequency_presence(tl, tlast, 0.4, 0.2).numpy(),
        np.asarray(jsmp.apply_frequency_presence(jl, jlast, 0.4, 0.2)),
        rtol=1e-6, atol=1e-6)


def test_greedy_penalized_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    for trial in range(30):
        x = np.round(rng.standard_normal((2, 64)) * 2).astype(np.float32)
        last = rng.integers(-1, 64, (2, 8))
        for rp, af, ap in ((1.3, 0.0, 0.0), (1.0, 0.5, 0.2), (2.0, 0.0, 0.0),
                           (0.5, 0.0, 0.0)):
            kw = dict(temp=0.0, repeat_penalty=rp, frequency_penalty=af,
                      presence_penalty=ap)
            want = jsmp.greedy_penalized(jnp.asarray(x),
                                         jnp.asarray(last, jnp.int32),
                                         JGen(**kw))
            got = tsmp.greedy_penalized(torch.from_numpy(x),
                                        torch.from_numpy(last),
                                        GenerationConfig(**kw))
            assert got.tolist() == np.asarray(want).tolist(), (trial, kw)


def test_sample_pipeline_draws_from_the_kept_set():
    """The RNG streams differ, so a sampled path is held to JAX's kept set:
    every draw lies in it, and greedy is exact."""
    _, jl, tl = _logits(4, b=2, v=100)
    g = GenerationConfig(temp=0.7, top_k=10, top_p=0.9, repeat_penalty=1.0)
    kept = _kept(jsmp.top_p_mask(jsmp.top_k_mask(jl, 10), 0.9))
    state = tsmp.SamplerState.init(7, 2, g.mirostat_tau, device="cpu")
    seen = set()
    for _ in range(50):
        tok, state = tsmp.sample(tl, state, g)
        for row, t in enumerate(tok.tolist()):
            assert kept[row, t]
            seen.add((row, t))
    assert len(seen) > 2
    jtok, _ = jsmp.sample(jl, jsmp.SamplerState.init(0, 2, 5.0),
                          JGen(temp=0.0))
    ttok, _ = tsmp.sample(tl, state, GenerationConfig(temp=0.0))
    assert ttok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("version", [1, 2])
def test_mirostat_updates_mu(version):
    _, _, tl = _logits(5, b=2, v=300)
    g = GenerationConfig(temp=1.0, mirostat=version, mirostat_tau=5.0,
                         mirostat_eta=0.1)
    state = tsmp.SamplerState.init(0, 2, 5.0, device="cpu")
    tok, state2 = tsmp.sample(tl, state, g)
    assert tok.shape == (2,) and (tok >= 0).all() and (tok < 300).all()
    assert not torch.equal(state2.mu, torch.full((2,), 10.0))
