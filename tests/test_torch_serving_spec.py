"""The port's ServingEngine with logprobs, speculative (prompt-lookup)
ticks and multimodal (input_embeds) requests on the CPU: twins of the JAX
package's tests/test_serving.py cases, each on the same tiny model as the
JAX ServingEngine or Engine where the JAX side is run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation.engine import Engine as JEngine
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.runtime import serving as jserving
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.runtime import serving as tserving
from tinychatengine_tpu_torch.runtime.serving import ServingEngine

TINY = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
            num_layers=2, max_sqlen=128, embed_dim=128, hidden_dim=256,
            vocab_size=256, rms_norm_eps=1e-5)
PROMPTS = [np.array([5, 9, 11]), np.array([7, 3]),
           np.array([100, 101, 102, 103, 104, 105])]
GREEDY = dict(temp=0.0, repeat_penalty=1.0, repeat_last_n=1)
# logprobs against log-softmax of the raw forward: JAX's own test's bound
LP_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX package's tiny model and the port's copy of its weights."""
    jcfg, jq = JModelConfig(**TINY), JQuantConfig(scheme="fp")
    jp = jllama.init_random_params(jcfg, jq, seed=0)
    cfg, q = ModelConfig(**TINY), QuantConfig(scheme="fp")
    tp = llama.params_from_numpy(jckpt._flatten(jp)[0], cfg, q, device="cpu")
    return (jp, jcfg, jq), (tp, cfg, q)


def _srv(models, n_predict, **kw):
    tp, cfg, q = models[1]
    return ServingEngine(tp, cfg, q, device="cpu", gcfg=GenerationConfig(
        n_predict=n_predict, **GREEDY), **kw)


def _engine(models):
    tp, cfg, q = models[1]
    return Engine(tp, cfg, q, batch=1, max_len=cfg.max_sqlen, device="cpu")


# ---- logprobs ---------------------------------------------------------------

def _oracle(models, prompt, tokens):
    """log-softmax of the port's eager forward, teacher-forced over the
    prompt and the emitted tokens: [len(tokens), V]."""
    tp, cfg, _ = models[1]
    cache = kvc.init_cache(cfg.num_layers, 1, cfg.max_sqlen,
                           cfg.num_kv_heads, cfg.head_dim, device="cpu")
    ids = torch.as_tensor(np.concatenate([prompt, tokens[:-1]]))[None]
    logits, _ = llama.forward(tp, cfg, ids, cache, 0, full_logits=True)
    return torch.log_softmax(logits[0, len(prompt) - 1:].float(), -1).numpy()


@pytest.mark.parametrize("slots,tick_batch", [(2, 8), (1, 1)],
                         ids=["batched_admission_bursts",
                              "single_admission_ticks"])
def test_logprobs_match_forward_oracle_and_jax(models, slots, tick_batch):
    """A logprobs request beside a plain one: every emitted token's logprob
    within LP_TOL of the raw forward's log-softmax (the first token from
    the admission, the rest from bursts or single ticks), tops descending
    and <= 0 with the greedy top-1 the chosen token, the plain request
    untouched, tokens as without logprobs, and tokens, logprobs and top ids
    as the JAX ServingEngine gives them."""
    srv = _srv(models, 8, slots=slots, tick_batch=tick_batch, logprobs_k=4)
    r1 = srv.submit(PROMPTS[0], logprobs=3)
    r2 = srv.submit(PROMPTS[1])
    srv.run()
    assert r2.output_logprobs == [] and r2.output_top_logprobs == []
    assert len(r1.output_logprobs) == len(r1.output_ids) == 8
    lsm = _oracle(models, PROMPTS[0], r1.output_ids)
    for t, (tok, lp, top) in enumerate(zip(
            r1.output_ids, r1.output_logprobs, r1.output_top_logprobs)):
        assert abs(lsm[t, tok] - lp) < LP_TOL
        assert len(top) == 3 and top[0][0] == tok
        assert abs(top[0][1] - lp) < 1e-5
        lps = [v for _, v in top]
        assert lps == sorted(lps, reverse=True) and max(lps) <= 1e-6
        np.testing.assert_allclose(lps, np.sort(lsm[t])[::-1][:3],
                                   atol=LP_TOL)
    solo = _srv(models, 8, slots=1)
    s1 = solo.submit(PROMPTS[0])
    solo.run()
    assert r1.output_ids == s1.output_ids

    jp, jcfg, jq = models[0]
    jsrv = jserving.ServingEngine(jp, jcfg, jq, slots=slots,
                                  tick_batch=tick_batch, logprobs_k=4,
                                  gcfg=JGen(n_predict=8, **GREEDY))
    j1 = jsrv.submit(PROMPTS[0].astype(np.int32), logprobs=3)
    jsrv.submit(PROMPTS[1].astype(np.int32))
    jsrv.run()
    assert r1.output_ids == j1.output_ids
    np.testing.assert_allclose(r1.output_logprobs, j1.output_logprobs,
                               atol=LP_TOL)
    assert [[i for i, _ in top] for top in r1.output_top_logprobs] == \
        [[i for i, _ in top] for top in j1.output_top_logprobs]


def test_logprobs_paged_and_validation(models):
    """The paged server serves logprobs (the k alternatives and the
    chosen-only form) equal to the dense server's; submit refuses k beyond
    logprobs_k."""
    out = {}
    for paged in (False, True):
        kw = dict(paged=True, page_size=16, n_pages=32) if paged else {}
        srv = _srv(models, 6, slots=2, logprobs_k=2, **kw)
        with pytest.raises(ValueError):
            srv.submit(PROMPTS[0], logprobs=3)
        r = srv.submit(PROMPTS[0], logprobs=2)
        r0 = srv.submit(PROMPTS[1], logprobs=0)
        srv.run()
        assert len(r.output_logprobs) == len(r.output_ids) == 6
        assert all(len(t) == 2 for t in r.output_top_logprobs)
        assert len(r0.output_logprobs) == 6
        assert all(t == [] for t in r0.output_top_logprobs)
        out[paged] = (r.output_ids, r.output_logprobs, r0.output_ids,
                      r0.output_logprobs)
    assert out[True][0] == out[False][0] and out[True][2] == out[False][2]
    np.testing.assert_allclose(out[True][1], out[False][1], atol=LP_TOL)
    np.testing.assert_allclose(out[True][3], out[False][3], atol=LP_TOL)


def test_token_logprobs_ties_match_jax():
    """Tied logits: the top-k ids come in lax.top_k's order (value
    descending, then index ascending), also where the ties straddle the
    k-th place; the logprobs equal JAX's."""
    rng = np.random.default_rng(0)
    logits = rng.integers(-3, 3, (6, 40)).astype(np.float32)
    logits[0, [3, 17, 29]] = 9.0
    tok = rng.integers(0, 40, 6)
    for k in (0, 1, 4, 7):
        lp, ti, tl = tserving._token_logprobs(torch.from_numpy(logits),
                                              torch.from_numpy(tok), k)
        jlp, jti, jtl = jserving._token_logprobs(
            jnp.asarray(logits), jnp.asarray(tok, jnp.int32), lp_k=k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jtl), atol=1e-6)
    assert ti[0, :3].tolist() == [3, 17, 29]


# ---- speculative ticks --------------------------------------------------------

REP = np.tile(np.array([5, 9, 11, 7]), 6)   # a repetitive prompt


def test_speculative_serving_exact_with_fewer_ticks(models):
    """Greedy requests through speculative serving: the tokens of the
    port's plain serving and of the JAX package's speculative serving,
    with accepted drafts, so more tokens than speculative ticks, and the
    same speculative tick and token counts as JAX's."""
    def run(spec):
        srv = _srv(models, 24, slots=2, tick_batch=1, speculative=spec)
        reqs = [srv.submit(p) for p in (REP, PROMPTS[0], PROMPTS[2])]
        srv.run()
        return srv, [r.output_ids for r in reqs]
    plain, want = run(False)
    srv, got = run(True)
    assert got == want
    assert srv._spec_stats["ticks"] > 0
    assert srv._spec_stats["tokens"] > srv._spec_stats["ticks"]
    assert srv.tick_stats["spec_ticks"] == srv._spec_stats["ticks"]
    assert plain.tick_stats["spec_ticks"] == 0

    jp, jcfg, jq = models[0]
    jsrv = jserving.ServingEngine(jp, jcfg, jq, slots=2, tick_batch=1,
                                  gcfg=JGen(n_predict=24, **GREEDY),
                                  speculative=True)
    jreqs = [jsrv.submit(p.astype(np.int32))
             for p in (REP, PROMPTS[0], PROMPTS[2])]
    jsrv.run()
    assert got == [r.output_ids for r in jreqs]
    assert srv._spec_stats == jsrv._spec_stats


def test_speculative_pauses_for_stochastic_neighbor(models):
    """A sampled request in the batch holds speculation off while it is
    active; both requests' tokens equal the plain server's."""
    hot = GenerationConfig(temp=1.2, top_p=0.9, n_predict=16,
                           repeat_penalty=1.0, repeat_last_n=1, seed=7)

    def run(spec):
        srv = _srv(models, 16, slots=2, tick_batch=1, speculative=spec)
        ra = srv.submit(PROMPTS[0])
        rb = srv.submit(PROMPTS[1], gcfg=hot)
        srv.run()
        return ra.output_ids, rb.output_ids
    assert run(True) == run(False)


def test_speculative_stop_token_mid_run(models):
    """A stop token inside an accepted run ends the request right there."""
    rep = np.arange(10, 40)
    probe = _srv(models, 40, slots=1, tick_batch=1)
    r0 = probe.submit(rep)
    probe.run()
    cut = next(i for i in range(2, 39)
               if r0.output_ids[i] not in r0.output_ids[:i])
    srv = _srv(models, 40, slots=1, tick_batch=1, speculative=True)
    r = srv.submit(rep, stop_token_ids=(r0.output_ids[cut],))
    srv.run()
    assert r.finish_reason == "stop"
    assert r.output_ids == r0.output_ids[:cut + 1]


def test_speculative_ineligible_rows(models):
    """Greedy with a logit_bias keeps the bias (no spec tick: the verify's
    raw argmax would drop it); a logprobs request holds speculation off;
    paged serving and the engine-global sampler turn speculation off."""
    srv = _srv(models, 6, slots=1, speculative=True)
    r = srv.submit(PROMPTS[0], gcfg=GenerationConfig(
        n_predict=6, logit_bias={99: 1e9}, **GREEDY))
    srv.run()
    assert r.output_ids == [99] * 6
    assert srv._spec_stats["ticks"] == 0
    srv = _srv(models, 12, slots=1, tick_batch=1, speculative=True)
    r = srv.submit(REP, logprobs=1)
    srv.run()
    assert srv._spec_stats["ticks"] == 0 and len(r.output_logprobs) == 12
    assert not _srv(models, 4, paged=True, page_size=16,
                    speculative=True).speculative
    tp, cfg, q = models[1]
    bias = {i: -1e9 for i in range(20, 40)}
    glob = ServingEngine(tp, cfg, q, device="cpu", speculative=True,
                         gcfg=GenerationConfig(n_predict=4, logit_bias=bias,
                                               **GREEDY))
    assert not glob.speculative


# ---- multimodal (input_embeds) requests ---------------------------------------

def _embeds_for(tp, ids, image_rows=()):
    """The prompt's table rows with synthetic image vectors at
    ``image_rows``."""
    emb = tp.embed[torch.as_tensor(ids)].float().numpy()
    rng = np.random.default_rng(7)
    for pos in image_rows:
        emb[pos] = rng.standard_normal(emb.shape[1]).astype(np.float32) * 0.05
    return emb


def _engine_tokens(models, ids, emb, n):
    """The port's Engine and the JAX Engine on the same embeds (greedy):
    both token lists."""
    g = dict(n_predict=n, **GREEDY)
    got = _engine(models).generate(
        ids[None], GenerationConfig(**g),
        input_embeds=None if emb is None else torch.from_numpy(emb)[None]
    ).tokens[0]
    jp, jcfg, jq = models[0]
    want = JEngine(jp, jcfg, jq, batch=1).generate(
        ids[None].astype(np.int32), JGen(**g),
        input_embeds=None if emb is None else
        jnp.asarray(emb, jnp.bfloat16)[None]).tokens[0]
    return list(got), list(want)


def test_embeds_request_matches_engine(models):
    """A multimodal request beside a text one decodes as the same embeds
    through the Engine (the port's and JAX's); the image rows change the
    tokens; a wrong shape is refused."""
    tp = models[1][0]
    ids = np.array([3, 0, 0, 0, 9, 17])
    emb = _embeds_for(tp, ids, image_rows=(1, 2, 3))
    want, jwant = _engine_tokens(models, ids, emb, 10)
    assert want == jwant
    assert want != _engine_tokens(models, ids, None, 10)[0]
    srv = _srv(models, 10, slots=2)
    rm = srv.submit(ids, input_embeds=emb)
    rt = srv.submit(PROMPTS[0])
    srv.run()
    assert rm.output_ids == want
    assert rt.output_ids == list(_engine(models).generate(
        PROMPTS[0][None], GenerationConfig(n_predict=10, **GREEDY)).tokens[0])
    assert srv.tick_stats["batch_admits"] == 0
    with pytest.raises(ValueError):
        srv.submit(ids, input_embeds=emb[:3])


def test_embeds_chunked_admission_exact(models):
    """A 64-token multimodal prompt admitted 16 tokens a tick: the chunks
    carry their embeds, the last one padded; tokens equal the Engine's."""
    tp = models[1][0]
    ids = (np.arange(20, 84) % 255) + 1
    ids[5:21] = 0
    emb = _embeds_for(tp, ids, image_rows=range(5, 21))
    want, jwant = _engine_tokens(models, ids, emb, 8)
    assert want == jwant
    srv = _srv(models, 8, slots=2, admission_chunk=16)
    r = srv.submit(ids, input_embeds=emb)
    srv.run()
    assert r.output_ids == want
    assert srv.tick_stats["admit_chunks"] == 4


def test_embeds_bypass_prefix_cache(models):
    """A multimodal request neither stores nor hits the token-keyed prefix
    cache, and a later text request with the same ids is not served its
    KV."""
    tp = models[1][0]
    ids = (np.arange(1, 65) % 255) + 1
    emb = _embeds_for(tp, ids, image_rows=(0, 1, 2, 3))
    srv = _srv(models, 6, slots=1, prefix_cache_entries=2, prefix_min=16)
    srv.submit(ids, input_embeds=emb)
    srv.run()
    assert srv.prefix_stats == {"hits": 0, "hit_tokens": 0, "stores": 0}
    rt = srv.submit(ids)
    srv.run()
    assert rt.output_ids == _engine_tokens(models, ids, None, 6)[0]
    assert srv.prefix_stats["hits"] == 0 and srv.prefix_stats["stores"] == 1


def test_embeds_preemption_resume_exact(models):
    """A multimodal request preempted mid-generation resumes exactly: its
    embeds grow by its emitted tokens' table rows."""
    tp = models[1][0]
    ids = np.array([3, 0, 0, 9, 17, 4, 8])
    emb = _embeds_for(tp, ids, image_rows=(1, 2))
    want = _engine_tokens(models, ids, emb, 12)[0]
    srv = _srv(models, 12, slots=2, paged=True, page_size=16, tick_batch=1)
    r = srv.submit(ids, input_embeds=emb)
    for _ in range(5):
        srv.step()
    assert r.output_ids and not r.finished
    slot_idx = next(i for i, s in enumerate(srv.slots) if s.request is r)
    n_out = len(r.output_ids)
    srv._preempt(slot_idx)
    assert len(r.input_embeds) == len(r.prompt_ids) == len(ids) + n_out
    np.testing.assert_array_equal(
        r.input_embeds[len(ids):],
        tp.embed[torch.as_tensor(r.output_ids)].float().numpy())
    srv.run()
    assert r.output_ids == want
